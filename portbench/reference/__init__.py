"""The benchmark's plain references: one module per model family
(``qwen2``, over ``lm``, the dense decoder in float32), each the only place
that knows its model, and ``bsp`` (the superstep around any of them:
buckets, error feedback, the wire codec on every halving hop, ZeRO-1
AdamW)."""
