"""Multi-rank runtime and sharded paths (counterpart: openmvg_tpu/parallel/).

  runtime.py        torch.distributed bring-up (one process a rank), the
                    rank grouping of a node, and spawn() for the CLI and
                    the tests
  mesh.py           a Mesh: a process group, its ranks and this rank's
                    device; row shards and the collectives the sharded
                    paths use (host staging under gloo)
  partitioner.py    pair-list and observation-table partitions
  dist_ba.py        observation- and point-sharded bundle adjustment
  ring_matching.py  ring-streamed all-pairs brute-force matching on K1
  scaling_bench.py  the scaling harness over mesh prefixes

It imports torch and numpy; never jax and never openmvg_tpu.
"""
