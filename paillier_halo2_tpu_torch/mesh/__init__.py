"""The mesh layer: shards on a list of torch devices, driven by one process
(`sharding`), the four-step NTT (`ntt`) and the sharded MSM (`msm`)."""
