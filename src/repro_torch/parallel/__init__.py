"""Meshes, sharding rules and shard-local execution over DTensors."""
from repro_torch.parallel.dist import (current_mesh, fake_world, local_map,
                                       make_mesh, mesh_axis_sizes,
                                       parse_mesh, single_process_world,
                                       spmd_world, sweep_mesh, use_mesh,
                                       world_backend)
from repro_torch.parallel.sharding import (RULE_VARIANTS, ShardingRules,
                                           act_pspec, constrain,
                                           current_rules, param_pspec,
                                           spec_placements, use_rules)

__all__ = ["RULE_VARIANTS", "ShardingRules", "act_pspec", "constrain",
           "current_mesh", "current_rules", "fake_world", "local_map",
           "make_mesh", "mesh_axis_sizes", "param_pspec", "parse_mesh",
           "single_process_world", "spec_placements", "spmd_world",
           "sweep_mesh", "use_mesh", "use_rules", "world_backend"]
