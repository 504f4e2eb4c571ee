"""Serving tier of the port: step engines, context-switching server,
request schedulers and telemetry."""
