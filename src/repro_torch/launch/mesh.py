"""Serving-mesh helpers of the launcher (PyTorch port of the part of
``repro.launch.mesh`` that ``launch/serve.py`` calls).

One card has no mesh: :func:`parse_mesh_shape` reads a ``--mesh-shape``
value as the JAX package does, and :func:`make_serve_mesh` refuses any
mesh, as the engine's ``mesh=`` does, until tensor-parallel serving is
ported (ROADMAP queue 1 item 12).
"""

from __future__ import annotations


def parse_mesh_shape(spec: str):
    """Parse a ``--mesh-shape`` string into (data, model) sizes.

    Accepts a bare model-axis size ("8" -> data=1, model=8) or an
    explicit "DATAxMODEL" / "DATA,MODEL" pair ("2x4" -> data=2, model=4).

    >>> parse_mesh_shape("8")
    (1, 8)
    >>> parse_mesh_shape("2x4")
    (2, 4)
    """
    parts = [int(p) for p in spec.lower().replace("x", ",").split(",") if p]
    if not parts or any(p < 1 for p in parts) or len(parts) > 2:
        raise ValueError(f"mesh shape {spec!r}: expected 'MODEL' or "
                         "'DATAxMODEL' with positive sizes")
    if len(parts) == 1:
        return 1, parts[0]
    return parts[0], parts[1]


def make_serve_mesh(spec: str):
    """The ("data", "model") serving mesh of a ``--mesh-shape`` value: not
    ported; raises for any mesh (the value is parsed first, so a malformed
    one raises the parser's ValueError)."""
    data, model = parse_mesh_shape(spec)
    raise NotImplementedError(
        f"a {data}x{model} serving mesh: tensor-parallel serving is not "
        "ported yet (ROADMAP queue 1 item 12)")
