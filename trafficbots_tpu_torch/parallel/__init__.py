"""Data parallelism: one process a rank over torch.distributed (mesh.py), a
launcher of local ranks (launch.py) and the multi-process dry run (dryrun.py)."""
