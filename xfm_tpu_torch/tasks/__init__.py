"""Task entry points of the port: the retrieval eval."""
