"""Device-resident index and serving path of the torch port."""
