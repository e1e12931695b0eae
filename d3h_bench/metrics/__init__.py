"""Per-layer metrics of the traced run, one reader module each."""
