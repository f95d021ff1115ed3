"""Multi-device execution: the distsql/coprocessor tier over a device
mesh (counterpart of tidb_tpu/parallel/).

  * distsql/ + store/copr/ -> sharded partitions (partition.py) and
    per-shard scan fragments (distsql.py, fragment.py)
  * HashAggExec's partial/final workers -> per-shard partial segment
    aggregation merged by psum/pmin/pmax over the mesh
  * HashJoinExec's build/probe workers + the MPP exchange -> a hash
    repartition by all_to_all and a local sorted-range join per shard
  * the region cache's routing -> placement on a (dcn x shard) Mesh of
    torch devices, driven by one controller (mesh.run_spmd)
"""

from tidb_tpu_torch.parallel.mesh import Mesh, dcn_axis, make_mesh, shard_axis
from tidb_tpu_torch.parallel.partition import ShardedTable, shard_table
from tidb_tpu_torch.parallel.distsql import (
    dist_agg_fragment,
    dist_join_agg_fragment,
    make_agg_fragment,
    make_join_agg_fragment,
    merge_state,
    repartition_by_key,
)

__all__ = [
    "make_mesh",
    "shard_axis",
    "dcn_axis",
    "ShardedTable",
    "shard_table",
    "dist_agg_fragment",
    "make_agg_fragment",
    "make_join_agg_fragment",
    "dist_join_agg_fragment",
    "merge_state",
    "repartition_by_key",
    "Mesh",
]
