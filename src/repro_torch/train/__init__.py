"""Training: the microbatched step, chunked cross-entropy, AdamW."""
