"""Multi-device layout of the port (the ingest mesh's slot blocks)."""
