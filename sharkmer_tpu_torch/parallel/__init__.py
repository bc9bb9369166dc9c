"""Sharded count tables: the k-mer keyspace split into owner shards, all
held on the engine's one device (torch port of ``sharkmer_tpu.parallel``)."""

from .sharded_table import ShardedKmerTable, make_mesh  # noqa: F401
