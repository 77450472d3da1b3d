"""Synthetic token streams for training (`pipeline`)."""
