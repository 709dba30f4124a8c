"""Focus core: clustering, the top-K index, ingest and query."""
