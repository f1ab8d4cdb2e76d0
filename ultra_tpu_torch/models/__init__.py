"""ULTRA models: the relational convolution, the NBFNets and their composition."""
