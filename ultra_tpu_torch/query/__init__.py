"""UltraQuery on the port: complex logical queries answered zero-shot by an
ULTRA model (``ops``, ``datasets``, ``metrics``, ``executor``,
``trainer``). Counterpart of ``ultra_tpu/query``; its training half
(symbolic traversal, traversal dropout, ``train_queries``, pretraining) is
ROADMAP A10."""
