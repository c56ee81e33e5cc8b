"""BNN core math on int32-packed bit words (see packing.py)."""
