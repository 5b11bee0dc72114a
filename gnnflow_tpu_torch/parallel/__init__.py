"""Multi-GPU training: process groups, data parallelism, the partitioned
store with routed sampling, sharded feature tables and node memory, and
the trainer over them (counterpart of ``gnnflow_tpu/parallel``)."""
from gnnflow_tpu_torch.parallel.dispatcher import dispatch_full_dataset
from gnnflow_tpu_torch.parallel.dist_context import (DistContext, initialize,
                                                     owned_partitions,
                                                     shutdown, spawn)
from gnnflow_tpu_torch.parallel.dist_graph import (
    DistributedTemporalSampler, PartitionedDeviceGraph,
    PartitionedDynamicGraph, routed_load_stats, sample_hops_partitioned,
    sample_hops_routed, sample_layer_replicated, sample_layer_routed)
from gnnflow_tpu_torch.parallel.dp import DataParallel, shard_trainer
from gnnflow_tpu_torch.parallel.kvstore import (ShardedFeatureStore,
                                                ShardedTable,
                                                shard_memory_state,
                                                unshard_memory)
from gnnflow_tpu_torch.parallel.partition import (get_partitioner,
                                                  partition_metrics)
from gnnflow_tpu_torch.parallel.partitioned_trainer import PartitionedTrainer

__all__ = ["DistContext", "initialize", "shutdown", "spawn",
           "owned_partitions", "DataParallel", "shard_trainer",
           "get_partitioner", "partition_metrics",
           "PartitionedDynamicGraph", "PartitionedDeviceGraph",
           "DistributedTemporalSampler", "sample_layer_routed",
           "sample_layer_replicated", "sample_hops_routed",
           "sample_hops_partitioned", "routed_load_stats",
           "ShardedTable", "ShardedFeatureStore", "shard_memory_state",
           "unshard_memory", "dispatch_full_dataset",
           "PartitionedTrainer"]
