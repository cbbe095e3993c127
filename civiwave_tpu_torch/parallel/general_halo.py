"""Banded halo-exchange plan for the general (unstructured) path.

Port of :mod:`civiwave_tpu.parallel.general_halo` (numpy only).  The pack
sorts elements by their min corner node (after the RCM renumbering), so a
contiguous block partition of the node axis induces a contiguous element
partition whose cross-shard reach is bounded by the mesh's node
bandwidth:

* nodes split into S contiguous blocks of L = N*/S rows (build with
  ``pad_nodes`` a multiple of S);
* element e belongs to the shard owning its min corner: a contiguous range
  per shard, padded to the largest count E_s with dead rows (zero
  gradients and volume: exact no-ops);
* every node an element touches lies in [own block, own block + G), where
  G is the largest overhang past a block's end.

One matvec then needs two neighbour exchanges (``ops/general_sharded.py``):
the next shard's first G rows of x come back, and after a per-shard
assembly over L + G rows the G ghost-row partial sums go forward.

The plan is None (the caller falls back to the all-gather form) when the
mesh mixes tet and hex blocks or has none, N* does not divide S, the
elements are not sorted by min corner, G > L, or a shard-local node would
need a slot at or past ``csr_degree``.  Left out, as TPU padding (ROADMAP
"Do not port"): the reference's rounding of E_s up to its Pallas element
block; the port's kernels take any E_s.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# the plan's arrays (stacked over shards along their element or row axis)
# and its scalars, as the reference names them
HALO_ARRAYS = ("halo_conn", "halo_grads", "halo_vol", "halo_lam", "halo_mu",
               "halo_csr_idx", "halo_csr_weight")
HALO_META = ("halo_block", "halo_local_nodes", "halo_ghost", "halo_elems")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def plan_general_halo(model, n_shards: int) -> Optional[dict]:
    """The halo tables of a single-element-type PackedModel over
    ``n_shards`` shards (numpy arrays and ints, keyed as ``HALO_ARRAYS``
    and ``HALO_META``), or None where the model cannot be planned.

    Shard s's rows are elements ``[s E_s, (s+1) E_s)`` of the element
    tables (local node indices, ``conn - s L``) and rows
    ``[s (L+G), (s+1) (L+G))`` of the CSR (built over its own real
    elements only, slots in the order of its force rows)."""
    if n_shards < 1:
        return None
    has_tet = bool(model.padded_tet_count)
    has_hex = bool(model.padded_hex_count)
    if has_tet == has_hex:  # mixed or empty
        return None
    block = "tet" if has_tet else "hex"
    n_pad = int(model.padded_node_count)
    if n_pad % n_shards:
        return None
    L = n_pad // n_shards

    if block == "tet":
        conn_g = _host(model.conn_tet)
        grads_g = _host(model.grads_tet)  # (4, 3, T*)
        vol_g = _host(model.vol_tet)  # (T*,)
        lam_g, mu_g = _host(model.lam_tet), _host(model.mu_tet)
        e_real, nl = int(model.tet_count), 4
    else:
        conn_g = _host(model.conn_hex)
        grads_g = _host(model.grads_hex)  # (8, 8, 3, H*)
        vol_g = _host(model.vol_hex)  # (8, H*)
        lam_g, mu_g = _host(model.lam_hex), _host(model.mu_hex)
        e_real, nl = int(model.hex_count), 8
    if not conn_g.shape[0]:
        return None

    emin = conn_g.min(axis=1).astype(np.int64)
    emax = conn_g.max(axis=1).astype(np.int64)
    if np.any(np.diff(emin) < 0):
        return None  # not sorted by min corner

    bounds = np.searchsorted(emin, np.arange(n_shards + 1) * L).astype(np.int64)
    counts = np.diff(bounds)
    ghost = 0
    for s in range(n_shards):
        if counts[s]:
            reach = int(emax[bounds[s]:bounds[s + 1]].max())
            ghost = max(ghost, reach - ((s + 1) * L - 1))
    if ghost > L:
        return None  # the bandwidth exceeds one block
    e_s = int(counts.max())
    if e_s == 0:
        return None

    degree = int(model.csr_degree)
    halo_conn = np.zeros((n_shards * e_s, nl), np.int32)
    halo_grads = np.zeros(grads_g.shape[:-1] + (n_shards * e_s,), np.float32)
    halo_vol = np.zeros(vol_g.shape[:-1] + (n_shards * e_s,), np.float32)
    halo_lam = np.zeros(n_shards * e_s, np.float32)
    halo_mu = np.zeros(n_shards * e_s, np.float32)
    halo_csr_idx = np.zeros((n_shards * (L + ghost), degree), np.int32)
    halo_csr_w = np.zeros((n_shards * (L + ghost), degree), np.float32)

    for s in range(n_shards):
        b0, b1 = int(bounds[s]), int(bounds[s + 1])
        cnt = b1 - b0
        if not cnt:
            continue
        lo, base_e = s * L, s * e_s
        halo_conn[base_e:base_e + cnt] = conn_g[b0:b1] - lo
        halo_grads[..., base_e:base_e + cnt] = grads_g[..., b0:b1]
        halo_vol[..., base_e:base_e + cnt] = vol_g[..., b0:b1]
        halo_lam[base_e:base_e + cnt] = lam_g[b0:b1]
        halo_mu[base_e:base_e + cnt] = mu_g[b0:b1]
        # the CSR covers the shard's real elements only (padded global
        # elements repeat the last real conn with zero gradients)
        r1 = min(b1, e_real)
        if r1 <= b0:
            continue
        nodes = (conn_g[b0:r1].astype(np.int64) - lo).reshape(-1)
        rows_local = (np.arange(r1 - b0, dtype=np.int64)[:, None] * nl
                      + np.arange(nl, dtype=np.int64)[None, :]).reshape(-1)
        order = np.argsort(nodes, kind="stable")
        ns, rs = nodes[order], rows_local[order]
        slot = np.arange(len(ns)) - np.searchsorted(ns, ns)
        if slot.size and int(slot.max()) >= degree:
            return None  # cannot happen: a subset of the global incidences
        base_n = s * (L + ghost)
        halo_csr_idx[base_n + ns, slot] = rs
        halo_csr_w[base_n + ns, slot] = 1.0

    return dict(
        halo_block=block,
        halo_local_nodes=L,
        halo_ghost=ghost,
        halo_elems=e_s,
        halo_conn=halo_conn,
        halo_grads=halo_grads,
        halo_vol=halo_vol,
        halo_lam=halo_lam,
        halo_mu=halo_mu,
        halo_csr_idx=halo_csr_idx,
        halo_csr_weight=halo_csr_w,
    )
