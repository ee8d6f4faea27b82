"""Stream runtime of the port: pipeline, stream, engine and CLI."""
