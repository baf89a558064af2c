"""Tree convolution, TBCNN (ref: ``paddle_tpu/ops/graph.py``).

The tree walk is irregular host work: :func:`tree_patch_coefficients`
builds, in numpy, a dense coefficient tensor ``coef[b, root, node, 3]``
(the continuous-binary-tree weights ``eta_l``, ``eta_r``, ``eta_t`` of
each node in each root's patch, to ``max_depth``). The device op
:func:`tree_conv` is then two einsums over (coef, features, filter) for
the whole batch; gradients reach the features and the filter through
autograd, the coefficients being data.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.registry import register_op


def _build_adjacency(edges):
    """edges ``[E, 2]`` (1-indexed parent -> child, ended by (0, 0)) ->
    (children dict, node count); rows after the first (0, 0) are
    ignored (ref: ``graph.py:26``)."""
    tr = {}
    node_count = 0
    for u, v in edges:
        u, v = int(u), int(v)
        if u == 0 or v == 0:
            break
        node_count += 1
        tr.setdefault(u, []).append(v)
    return tr, node_count + 1


def _patch(root, max_depth, tr):
    """The DFS patch of ``(node, index, pclen, depth)`` under ``root``
    (ref: ``graph.py:41``)."""
    out = [(root, 1, 1, 0)]
    stack = [(root, 1, 1, 0)]
    visited = {root}
    while stack:
        node, _, _, depth = stack[-1]
        end = True
        kids = tr.get(node, [])
        for i, v in enumerate(kids):
            if v not in visited and depth + 1 < max_depth:
                visited.add(v)
                stack.append((v, i, len(kids), depth + 1))
                out.append((v, i + 1, len(kids), depth + 1))
                end = False
        if end:
            stack.pop()
    return out


def tree_patch_coefficients(edge_sets, n_nodes, max_depth):
    """Host-side tree2col (ref: ``graph.py:62``): edge_sets ``[B, E, 2]``
    -> coef ``[B, n_nodes, n_nodes, 3]`` float32 numpy, ``coef[b, root -
    1, node - 1] = (eta_l, eta_r, eta_t)``; revisits accumulate."""
    edge_sets = np.asarray(edge_sets)
    B = edge_sets.shape[0]
    coef = np.zeros((B, n_nodes, n_nodes, 3), np.float32)
    fd = float(max_depth)
    for b in range(B):
        tr, node_count = _build_adjacency(edge_sets[b])
        for root in range(1, node_count + 1):
            for node, idx, pclen, depth in _patch(root, max_depth, tr):
                eta_t = (fd - depth) / fd
                tmp = 0.5 if pclen == 1 else (idx - 1.0) / (pclen - 1.0)
                eta_l = (1.0 - eta_t) * tmp
                eta_r = (1.0 - eta_t) * (1.0 - tmp)
                coef[b, root - 1, node - 1, 0] += eta_l
                coef[b, root - 1, node - 1, 1] += eta_r
                coef[b, root - 1, node - 1, 2] += eta_t
    return coef


@register_op("tree_conv")
def tree_conv(nodes_vector, coef, filter):
    """TBCNN convolution (ref: ``graph.py:92``): nodes ``[B, N, F]``, coef
    ``[B, N, N, 3]``, filter ``[F, 3, O, M]`` -> ``[B, N, O, M]``; a root
    past the sample's node count gives zeros."""
    enforce(filter.ndim == 4 and filter.shape[1] == 3,
            "tree_conv filter must be [F, 3, output_size, num_filters]")
    patch = torch.einsum("brnk,bnf->brfk", coef.to(nodes_vector.dtype),
                         nodes_vector)
    return torch.einsum("brfk,fkom->brom", patch, filter)


def tree_conv_layer(nodes_vector, edge_set, filter, max_depth):
    """The reference layer's signature (ref: ``graph.py:108``): the
    coefficients built on the host from the concrete ``edge_set``, then
    :func:`tree_conv`."""
    n = nodes_vector.shape[1]
    coef = torch.from_numpy(tree_patch_coefficients(
        np.asarray(edge_set), n, max_depth)).to(nodes_vector.device)
    return tree_conv(nodes_vector, coef, filter)
