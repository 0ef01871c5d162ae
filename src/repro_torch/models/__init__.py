"""Models (this slice: the paper's Section-5.2 MLP)."""
