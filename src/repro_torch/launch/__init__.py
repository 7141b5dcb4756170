"""Launch layer of the port: the serving entry point."""
