"""Sharded count tables: the k-mer keyspace split into owner shards,
placed on a list of devices (``device.shard_devices``; torch port of
``sharkmer_tpu.parallel``)."""

from .sharded_table import ShardedKmerTable  # noqa: F401
