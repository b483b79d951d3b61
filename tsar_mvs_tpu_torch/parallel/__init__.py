"""View sharding: each rank of a torch.distributed group runs its slice of
the reference views (port of ``tsar_mvs_tpu.parallel``)."""
