"""The benchmark's plain references: ``lm`` (the dense decoder in float32),
one module per model family mapping a configuration file onto it, and
``bsp`` (the superstep around it: buckets, error feedback, the wire codec
on every halving hop, ZeRO-1 AdamW)."""
