"""Models: the cheap ingest CNN and the dense decoder LM (layers,
transformer)."""
