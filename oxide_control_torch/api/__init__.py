"""Environment API of the port (see ``api.environment``)."""
