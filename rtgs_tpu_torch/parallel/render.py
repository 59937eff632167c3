"""Multi-device rendering: tiles data-parallel over the ``rays`` axis × a
ring over splat shards on the ``prims`` axis (port of
:mod:`rtgs_tpu.parallel.render`).

Rays are stationary queries, and the splat shards rotate round the ring
of each rays-row: per ring step every rank takes the K nearest hits of its
rays in the shard it holds and merges them by (entry depth, splat index)
into its running K-list, which after the whole ring is the global K
nearest, ties broken as the single-device paths break them. Every rank
returns the whole result, the same on every rank.

Differentiable end to end, by four autograd Functions that do what JAX
gets from transposing its collectives:

  * :class:`_RingShift` sends the shard to the next prims-rank and receives
    the previous one's; its backward sends the cotangent the other way;
  * :class:`_SumOverRays` is the identity at a shard's entry, whose
    backward sums the shard's gradient over the rays group (every rays-rank
    holds the same shard; ``shard_map`` inserts this ``psum`` by itself);
  * :class:`_GatherRays` gathers the rays-ranks' tiles; its backward takes
    this rank's slice of the cotangent. (``torch.distributed.nn``'s
    ``all_gather`` sums every rank's cotangent instead, which multiplies the
    gradient by n_rays when each rank backs up the same whole-image loss.)
  * :class:`_ShareOverPrims`: after the whole ring every prims-rank of a
    row holds the same K-lists, and each backs up the same loss through
    every shard; its backward keeps the cotangent of every n_prims-th row
    only (rows ≡ prims-rank), so each row's gradient is counted once.

So the gradient assumes what the CLI and the tests do: every rank backs up
the same loss of the whole result.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from rtgs_tpu_torch import gaussians as G
from rtgs_tpu_torch.camera import Camera
from rtgs_tpu_torch.parallel.mesh import Mesh
from rtgs_tpu_torch.rays import Rays
from rtgs_tpu_torch.scene import pad_scene

# The scene fields that travel round the ring, and their widths per splat.
_FIELDS = G.FIELDS
_WIDTHS = (3, 4, 3, 3, 1, G.NUM_SH_COEFFS * 3, 1)


def shard_scene(g: G.Gaussians, mesh: Mesh) -> G.Gaussians:
    """Pad N to a multiple of the prims axis (dead splats,
    :func:`~rtgs_tpu_torch.scene.pad_scene`) and return this rank's shard on
    its device: rows ``[p·m, (p+1)·m)`` for prims-rank p. Every rank passes
    the same whole scene; gradients reach its rows of the shard."""
    g = pad_scene(g, mesh.n_prims)
    m = g.num // mesh.n_prims
    lo = mesh.prims_rank * m
    return G.Gaussians(**{f: getattr(g, f)[lo:lo + m].to(mesh.device)
                          for f in _FIELDS})


def _pack(g: G.Gaussians) -> torch.Tensor:
    """The shard as one (m, 60) tensor: one message a ring step."""
    return torch.cat([getattr(g, f).reshape(g.num, -1) for f in _FIELDS],
                     dim=1)


def _unpack(x: torch.Tensor) -> G.Gaussians:
    m = x.shape[0]
    parts = torch.split(x, _WIDTHS, dim=1)
    shapes = dict(opacities=(m,), mask=(m,),
                  sh=(m, G.NUM_SH_COEFFS, 3))
    return G.Gaussians(**{f: p.reshape(shapes.get(f, (m, -1)))
                          for f, p in zip(_FIELDS, parts)})


def _shift(x: torch.Tensor, mesh: Mesh, offset: int) -> torch.Tensor:
    """Send ``x`` to the prims-rank ``offset`` steps on and return what the
    one ``offset`` steps back sent."""
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, mesh.prims_peer(offset),
                      mesh.prims_group),
           dist.P2POp(dist.irecv, out, mesh.prims_peer(-offset),
                      mesh.prims_group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One step of the ring: the shard moves to the next prims-rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _shift(x, mesh, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.mesh, -1), None


class _SumOverRays(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the rays
    group (all-reduce)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.rays_group)
        return grad, None


class _GatherRays(torch.autograd.Function):
    """All-gather of equal (t, ...) slices over the rays group, in rays-rank
    order; the backward takes this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.n_rays)]
        dist.all_gather(parts, x, group=mesh.rays_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mesh.rays_rank * ctx.n
        return grad[lo:lo + ctx.n], None


class _ShareOverPrims(torch.autograd.Function):
    """Identity forward; the backward zeroes the cotangent of the rows that
    another prims-rank backs up (row i belongs to prims-rank i mod
    n_prims)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        own = (torch.arange(grad.shape[0], device=grad.device)
               % mesh.n_prims) == mesh.prims_rank
        return grad * own.reshape((-1,) + (1,) * (grad.dim() - 1)), None


def _enter(g_shard: G.Gaussians, mesh: Mesh) -> torch.Tensor:
    x = _pack(g_shard)
    return x if mesh.rays_group is None else _SumOverRays.apply(x, mesh)


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the result → the whole result on every rank."""
    if mesh.prims_group is None:
        return x
    return _GatherRays.apply(_ShareOverPrims.apply(x, mesh), mesh)


def _global_ids(local: torch.Tensor, mesh: Mesh, step: int,
                m: int) -> torch.Tensor:
    """A shard's splat ids (−1 vacant) as ids of the padded whole scene: at
    ring step s a prims-rank holds the shard of prims-rank p − s."""
    shard = (mesh.prims_rank - step) % mesh.n_prims
    return torch.where(local >= 0, local.long() + shard * m, -1)


def merge_layers(best, new, k: int, dim: int):
    """Merge two K-lists of layers along ``dim``, keeping the K first by
    (t1, splat index): layer 0 is t1, layer 1 the global splat index (any
    order-preserving id; −1 marks a vacancy, whose t1 is +inf), the others
    ride along. On a tie in t1 the lower splat index wins, as in the
    single-device keys path, so every prims-rank, whatever order the shards
    reach it in, keeps the same layers. (The JAX ring keeps the running
    list's layer, ``lax.top_k``'s lower position: its prims-ranks disagree
    where two shards tie.)"""
    cat = [torch.cat([b, n], dim=dim) for b, n in zip(best, new)]
    with torch.no_grad():
        by_id = torch.sort(cat[1], dim=dim, stable=True).indices
        by_t1 = torch.sort(cat[0].gather(dim, by_id), dim=dim,
                           stable=True).indices
        idx = by_id.gather(dim, by_t1).narrow(dim, 0, k)
    out = []
    for x in cat:
        ix = idx
        while ix.dim() < x.dim():
            ix = ix.unsqueeze(-1)
        out.append(x.gather(dim, ix.expand(*idx.shape, *x.shape[idx.dim():])))
    return tuple(out)


def render_sharded(g_shard: G.Gaussians, rays: Rays, depth: int,
                   mesh: Mesh):
    """The oracle ring: render a flat ray bundle (P,) against every shard,
    brute force (:func:`~rtgs_tpu_torch.render.oracle.topk_hits`), for
    parity tests of :func:`render_tiled_sharded` (it costs O(N·P)).

    ``g_shard`` is this rank's shard (:func:`shard_scene`); ``rays`` the
    whole bundle, the same on every rank, P a multiple of the rays axis
    (each rays-rank takes its contiguous slice). Returns the whole
    (radiance (P, 3), transmittance (P,)) on every rank."""
    from rtgs_tpu_torch.render.oracle import composite_hits, topk_hits

    p = rays.starts.shape[0]
    if p % mesh.n_rays:
        raise ValueError(f"{p} rays do not divide over {mesh.n_rays} "
                         "rays-ranks")
    pl = p // mesh.n_rays
    lo = mesh.rays_rank * pl
    local = Rays(*(x[lo:lo + pl].to(mesh.device) for x in rays))
    cur = _enter(g_shard, mesh)
    m = g_shard.num
    best = None
    for step in range(mesh.n_prims):
        t1, idx, alpha, rgb = topk_hits(_unpack(cur), local, depth,
                                        with_index=True)
        new = (t1, _global_ids(idx, mesh, step, m), alpha, rgb)
        best = new if best is None else merge_layers(best, new, depth, dim=1)
        if step < mesh.n_prims - 1:   # the last shift would be discarded
            cur = _RingShift.apply(cur, mesh)
    rad, trans = composite_hits(best[0], *best[2:])
    out = _gather(torch.cat([rad, trans[:, None]], dim=1), mesh)
    return out[:, :3], out[:, 3]


def render_tiled_sharded(
    g_shard: G.Gaussians,
    camera: Camera,
    mesh: Mesh,
    depth: int = 16,
    tile=(16, 16),
    max_candidates: int = 256,
    max_global: int = 64,
    bin_narrow: int | None = None,
) -> torch.Tensor:
    """The production ring: the keys path per shard. Returns the whole
    (W, H, 3) radiance on every rank, differentiable in ``g_shard``.

    Per ring step each rank bins the shard it holds
    (:func:`~rtgs_tpu_torch.render.binning.tile_candidates` with the chunk
    bounds and the proven entry bound
    :func:`~rtgs_tpu_torch.render.tiled.entry_lower_bound`), takes its
    rays-slice of the tiles, selects each pixel's K nearest (t1, splat id)
    with :func:`~rtgs_tpu_torch.ops.peel.peel_keys` (the keys kernel on the
    card, one launch a step, fed the binning's counts), shades only the
    winners (:func:`~rtgs_tpu_torch.render.tiled.shade_winners_kp`), merges
    the (T, K, P) layers t1, splat id, α, r, g, b along K into its running
    list by (t1, id) (:func:`merge_layers`) and passes the shard on. One composite at the
    end. The tiles are padded to a multiple of the rays axis (candidates
    −1, ``chunk_lb`` +inf, counts 0, zero pixel rows). There are no tile
    bands: the (T/n_rays, K, P, 64) winner-row gather of a step is whole.
    """
    from rtgs_tpu_torch.ops.peel import CHUNK, peel_keys
    from rtgs_tpu_torch.render.binning import tile_candidates
    from rtgs_tpu_torch.render.tiled import (_tile_pixel_features,
                                             _tiles_to_image,
                                             composite_layers_kp,
                                             entry_lower_bound,
                                             pack_features,
                                             precompute_features,
                                             shade_winners_kp)

    w, h = camera.buf_size
    tw, th = tile
    ntx, nty = -(-w // tw), -(-h // th)
    num_tiles = ntx * nty
    t_local = -(-num_tiles // mesh.n_rays)
    t_pad = t_local * mesh.n_rays - num_tiles
    lo = mesh.rays_rank * t_local

    def local(x, fill):
        if t_pad:
            pad = [0, 0] * (x.dim() - 1) + [0, t_pad]
            x = F.pad(x, pad, value=fill)
        return x[lo:lo + t_local].contiguous()

    pix = local(_tile_pixel_features(camera, tile), 0.0)
    cur = _enter(g_shard, mesh)
    m = g_shard.num
    best = None
    for step in range(mesh.n_prims):
        g = _unpack(cur)
        packed = pack_features(precompute_features(g, camera))
        with torch.no_grad():
            binning = tile_candidates(
                g, camera, tile=tile, max_candidates=max_candidates,
                max_global=max_global, narrow=bin_narrow, chunk=CHUNK,
                entry_lb=entry_lower_bound(g, camera, packed))
            cand = local(binning.candidates, -1)
            t1, sid = peel_keys(packed, cand, pix, depth,
                                chunk_lb=local(binning.chunk_lb,
                                               float("inf")),
                                counts=local(binning.counts, 0))
        new = (t1, _global_ids(sid, mesh, step, m),
               *shade_winners_kp(packed, sid, pix))
        best = new if best is None else merge_layers(best, new, depth, dim=1)
        if step < mesh.n_prims - 1:   # the last shift would be discarded
            cur = _RingShift.apply(cur, mesh)
    rad = _gather(composite_layers_kp(*best[2:]), mesh)[:num_tiles]
    return _tiles_to_image(rad, ntx, nty, tile)[:w, :h]
