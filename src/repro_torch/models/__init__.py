"""Models: the cheap ingest CNN."""
