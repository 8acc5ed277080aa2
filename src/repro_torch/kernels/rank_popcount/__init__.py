"""Rank-dictionary block popcounts for the succinct tree's bitmaps."""
