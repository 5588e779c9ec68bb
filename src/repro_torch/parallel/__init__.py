"""Multi-card sharding: meshes, partition specs and the leading-axis split
(:mod:`repro_torch.parallel.sharding`)."""
