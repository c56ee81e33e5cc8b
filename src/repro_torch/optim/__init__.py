"""Training's optimizer (``optimizer``: AdamW with a warm-up cosine
schedule and global-norm clipping) and the int8 error-feedback gradient
compression (``compress``)."""
