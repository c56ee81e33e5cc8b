"""Model layers (dense family): norms, rotary embeddings, projections,
attention, the paged attention block and the feed-forward block."""
