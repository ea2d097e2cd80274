"""Roofline accounting of the port: collective bytes at the gather
points (``hlo_stats``) and the three-term bound of a step
(``analysis``)."""
