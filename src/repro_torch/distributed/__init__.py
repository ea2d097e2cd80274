"""Distribution layer of the port: the sharding rule table and its
placement types (``sharding``), the gather points of the mesh data
plane (``act_sharding``) and the elastic planners (``elastic``)."""
