"""Per-pixel colour, tone-map and gain-map math on (3, H, W) float32
tensors."""
