"""Distributed substrate of the port: logical-axis sharding rules and the
tensor-parallel runtime of the serving engine.

Modules:
  sharding          logical-name -> mesh-axis rule translation, contexts and
                    spec inference (the JAX package's rules, copied), and
                    ``local_shard``, which cuts one rank's block
  tensor_parallel   the serving layout a rank holds (whole heads, whole
                    quantization groups), its collectives and the cut of
                    parameters, caches and adapters

Compressed gradient exchange, collective matmuls and stage pipelining are
training's (ROADMAP queue 1 item 12c).
"""

from repro_torch.dist import sharding  # noqa: F401
