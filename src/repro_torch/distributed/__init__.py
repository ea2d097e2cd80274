"""Distribution helpers of the port (only the elastic planners so far)."""
