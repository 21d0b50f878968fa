"""Halo (ghost-row) exchange of slab fields (counterpart of
``nbodykit_tpu/parallel/halo.py``).

Each rank paints into its slab extended by ``h`` rows on each side;
``halo_add`` ships the halo rows to the neighbours that own them and
adds them there, ``halo_fill`` copies the neighbours' edge rows into a
halo before a readout.

Layout (P ranks, n0 = N0 // P rows a rank): rank d owns global rows
[d*n0, (d+1)*n0); its extended buffer (n0 + 2h, ...) covers global rows
[d*n0 - h, (d+1)*n0 + h), periodic.

The JAX package's two ``ppermute``s (to the next and to the previous
device) become one ``all_to_all_single`` with uneven splits: each rank
sends ``h`` rows to each neighbour (``2h`` to the one other rank when P
is 2), the only collective that runs alike on gloo (host tensors),
gloo over a CUDA device (staged, see ``RankMesh``) and NCCL. Within the
rows bound to one rank, the rows for its role as our previous rank come
first.

Each is the other's adjoint. Under autograd the rows travel through
``RankMesh.all_to_all``, whose backward is the route back, so the
backward of one is the other.
"""

import torch

from .runtime import mesh_size


def _neighbour_exchange(to_prev, to_next, mesh):
    """Send ``to_prev`` to rank r-1 and ``to_next`` to rank r+1 (one
    collective); return (from_prev, from_next): what rank r-1 sent to
    its next rank and what rank r+1 sent to its previous rank."""
    P, r = mesh.size, mesh.rank
    h = to_prev.shape[0]
    prev, nxt = (r - 1) % P, (r + 1) % P
    send, splits = [], []
    for d in range(P):
        rows = []
        if d == prev:
            rows.append(to_prev)
        if d == nxt:
            rows.append(to_next)
        send += rows
        splits.append(h * len(rows))
    # rank s sends us its previous-role rows when we are s-1 (s = r+1)
    # and its next-role rows when we are s+1 (s = r-1)
    recv_splits = [h * ((s == nxt) + (s == prev)) for s in range(P)]
    got = mesh.all_to_all(torch.cat(send), splits, recv_splits)
    blocks = []
    at = 0
    for s in range(P):
        blocks.append(got[at:at + recv_splits[s]])
        at += recv_splits[s]
    # within rank s's block: previous-role rows (for us: s == nxt) first
    from_next = blocks[nxt][:h]
    from_prev = blocks[prev][-h:]
    return from_prev, from_next


def halo_add(ext, h, mesh):
    """Fold the halo rows of an extended slab onto their owners.

    ext : (n0 + 2h, ...) this rank's extended buffer; h : the halo
    width (the resampler's support); mesh : the RankMesh (None or one
    rank: the periodic wrap within the slab).

    Returns the (n0, ...) interior with the neighbours' halos added.
    """
    n0 = ext.shape[0] - 2 * h
    interior = ext[h:h + n0]
    if h == 0:
        return interior
    lo = ext[:h]              # rows owned by rank r-1
    hi = ext[h + n0:]         # rows owned by rank r+1
    if mesh_size(mesh) == 1:
        interior = interior.clone()
        interior[-h:] += lo
        interior[:h] += hi
        return interior
    # our lo rows go back to r-1, our hi rows forward to r+1; r+1's lo
    # rows are our tail, r-1's hi rows our head
    from_prev, from_next = _neighbour_exchange(lo, hi, mesh)
    interior = interior.clone()
    interior[n0 - h:] += from_next
    interior[:h] += from_prev
    return interior


def halo_fill(interior, h, mesh):
    """An extended slab (n0 + 2h, ...) whose halo rows copy the
    neighbours' edge rows (periodic): the companion of :func:`halo_add`
    before a readout."""
    if h == 0:
        return interior
    n0 = interior.shape[0]
    head = interior[:h]        # r-1's hi halo
    tail = interior[n0 - h:]   # r+1's lo halo
    if mesh_size(mesh) == 1:
        lo, hi = tail, head
    else:
        lo, hi = _neighbour_exchange(head, tail, mesh)
    return torch.cat([lo, interior, hi], dim=0)
