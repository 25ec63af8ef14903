"""Landmark-sharded local BA over `torch.distributed` (port of
`ssvio_tpu/parallel/`): `dist_ba.py` shards the problem and runs the
collective BA, `multihost.py` joins the processes into one group."""
