"""The LM side of the port (the dense family): configuration, layers,
self attention with KV caches, the transformer, batched generation, and
the carrying of the reference's parameters across (``weights``)."""
