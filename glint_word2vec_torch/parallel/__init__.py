"""The embedding engine of the port."""
