"""Domain decomposition over torch.distributed ranks (PyTorch port of
`qgdsolver_tpu.parallel`): each process owns one block of the structured
mesh, ghost layers at partition edges come from the neighbour ranks, and
the global reductions are collectives."""
