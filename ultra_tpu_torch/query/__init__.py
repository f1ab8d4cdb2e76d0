"""UltraQuery on the port: complex logical queries answered and trained on
by an ULTRA model (``ops``, ``datasets``, ``metrics``, ``executor``,
``trainer``, ``pretrain``). Counterpart of ``ultra_tpu/query``."""
