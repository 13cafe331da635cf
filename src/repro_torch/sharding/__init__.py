"""PartitionSpecs for the model scaffold's trees as plain tuples
(:mod:`repro_torch.sharding.rules`)."""
