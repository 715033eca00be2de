"""bfloat16 gradient mean with error feedback.

The port of the JAX package's ``dist/compression.py``.  Gradients go on the
wire in bfloat16 (half the all-reduce bytes); the rounding error is kept in
a float32 residual per leaf and added back before the next step's
rounding, so the SUM of the updates follows the true sum (error feedback,
not error discard).

Over a ``launch.mesh.DeviceMesh`` the semantics are the JAX package's for
the inputs it takes there (``in_specs=P()``): every slot along ``axis``
holds the same replicated leaf, so the mean of their identical bfloat16
copies is the rounded value itself, which is returned without a
collective.  The port's serving steps run sharded over a mesh
(``train.step.sharded_forward``, with the collectives of
``launch.mesh``), but training does not yet: gradients are not split over
"data", so this mean stays the replicated case, and a real collective
over the slots comes with sharded training.
"""
from __future__ import annotations

import torch


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def init_residual(grads):
    """Zero float32 residual matching the gradient tree."""
    return _tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                     grads)


def compressed_mean_grads(mesh, grads, residual, axis: str = "data"):
    """-> (mean_grads float32, new_residual): the mean over ``axis`` of
    ``mesh`` with a bfloat16 wire format and error feedback."""
    if axis not in mesh.axis_names:
        raise ValueError(f"compressed_mean_grads: no axis {axis!r} in mesh "
                         f"axes {mesh.axis_names}")

    def one(g, r):
        t = g.to(torch.float32) + r
        wire = t.to(torch.bfloat16).to(torch.float32)
        return wire, t - wire

    pairs = _tree_map(one, grads, residual)
    return _tree_map(lambda p: p[0], pairs), _tree_map(lambda p: p[1], pairs)
