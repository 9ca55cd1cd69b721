"""Step functions and the serving CLI of the port."""
