"""Exact k-nearest-neighbour search over L2-normalised patch embeddings, as
in the JAX package's ops/knn.py: squared-L2 neighbours are the top cosine
similarities, d² = 2 - 2·(q·x).

The crossover constants keep their JAX names and environment overrides; the
query threshold is kept by the rows' dtype and was measured on the H100
(PERF.md §6): the streaming kernel against the dense search (float32 matmul
+ the topk kernel) at 1024 to 8192 queries against 16,384 and 27,132 rows,
at the k of its callers (serving's K = 4, `map`'s 2K = 8). It is selected
where it wins by more than the 10% spread between chip calls at both:
bf16 rows (bf16 `mma`, the bf16 engines) from 1024 queries, the smallest
batch measured; float32 rows (3xTF32: `map` and the float32 engines) from
4096, since at 2048 queries and k = 8 the dense search is faster.
The row thresholds keep the v5e's values: below 16,384 rows nothing was
measured, and the million-row threshold needs no query batch.
The TPU tile sizes (SERVING_KNN_TILES) have no counterpart: the CUDA kernel
(ops/streaming_knn.py) fixes its own tiling.
"""

from __future__ import annotations

import os

import torch

PALLAS_KNN_MIN_ROWS = int(os.environ.get("RF_PALLAS_KNN_MIN_ROWS", 1_000_000))
#: the query crossover by the rows' dtype; RF_PALLAS_KNN_MIN_QUERIES sets float32's
PALLAS_KNN_MIN_QUERIES = {
    torch.float32: int(os.environ.get("RF_PALLAS_KNN_MIN_QUERIES", 4096)),
    torch.bfloat16: 1024,
}
PALLAS_KNN_MIN_ROWS_BATCHED = int(os.environ.get("RF_PALLAS_KNN_MIN_ROWS_BATCHED", 16384))


def iterative_topk(sims: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis by k rounds of max + mask.

    Equal values are taken in ascending index order (the jax.lax.top_k
    rule), written out because torch.topk does not promise it. Returns
    (values, int32 indices), best first. NaN-free input is assumed."""
    n = sims.shape[-1]
    ids = torch.arange(n, device=sims.device, dtype=torch.int32).expand(sims.shape)
    s = sims
    vals, idxs = [], []
    for _ in range(k):
        m = torch.amax(s, dim=-1, keepdim=True)
        sel = torch.where(s == m, ids, n).amin(dim=-1, keepdim=True)
        vals.append(m)
        idxs.append(sel)
        s = s.scatter(-1, sel.long(), float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def exact_knn(queries: torch.Tensor, database: torch.Tensor, k: int):
    """Top-k rows of `database` for each query (both L2-normalised), dense:
    one float32 score matrix, then the tie-exact select: the topk kernel
    (ops/topk.py) for the k it takes, the iterative select above it, as
    jax.lax.top_k takes any k. Returns (int32 indices,
    sq_dists = max(2 - 2·cos, 0))."""
    from retrieval_fuse_tpu_torch.ops.topk import TOPK_MAX_K, topk
    sims = queries.float() @ database.float().T
    select = topk if k <= TOPK_MAX_K else iterative_topk
    top_sims, top_idx = select(sims, k)
    return top_idx, torch.clamp(2.0 - 2.0 * top_sims, min=0.0)


def use_streaming_knn(n_rows: int, min_rows: int | None = None,
                      n_queries: int | None = None, dtype: torch.dtype = torch.float32) -> bool:
    """True where the streaming kernel is the selected search: the database
    alone crosses the row threshold, or the query batch and the database
    both cross the batched thresholds (the serving regime), the query
    threshold being that of the rows' dtype."""
    if n_rows >= (PALLAS_KNN_MIN_ROWS if min_rows is None else min_rows):
        return True
    min_queries = PALLAS_KNN_MIN_QUERIES.get(dtype)  # None: a dtype the kernel does not take
    return (n_queries is not None and min_queries is not None and n_queries >= min_queries
            and n_rows >= PALLAS_KNN_MIN_ROWS_BATCHED)


def auto_exact_knn(queries: torch.Tensor, database: torch.Tensor, k: int,
                   min_rows: int | None = None):
    """Exact kNN with the engine chosen by use_streaming_knn: the streaming
    kernel at or above the crossovers, the dense path below. The same
    indices either way, up to float32 summation order on near-ties."""
    if use_streaming_knn(database.shape[0], min_rows, n_queries=queries.shape[0],
                         dtype=database.dtype):
        from retrieval_fuse_tpu_torch.ops.streaming_knn import streaming_knn
        return streaming_knn(queries, database, k)
    return exact_knn(queries, database, k)


def shard_bounds(n_rows: int, n_shards: int, shard: int) -> tuple[int, int]:
    """[start, stop) of shard `shard` of `n_rows` database rows split into
    `n_shards` blocks of ceil(n_rows / n_shards), the last one short (or
    empty), as JAX pads the database to a multiple of the mesh."""
    size = -(-n_rows // n_shards)
    return min(shard * size, n_rows), min((shard + 1) * size, n_rows)


def shard_candidates(queries: torch.Tensor, shard_rows: torch.Tensor, k: int, offset: int,
                     shard_size: int, streaming: bool | None = None):
    """One shard's local top-k: (similarities (Q, kk) float32, global int64
    indices (Q, kk)), kk = min(k, shard_size), best first. The search is
    auto_exact_knn's at the shard's own size (the dense path and the topk
    kernel, or the streaming kernel); `shard_size` is the padded size of
    every shard, so a short or empty last shard fills its list with -inf
    similarities that never win a merge (JAX masks pad rows to -inf).
    `streaming` True / False forces the streaming kernel / the dense path."""
    kk = min(k, shard_size)
    q, n = queries.shape[0], shard_rows.shape[0]
    sims = torch.full((q, kk), float("-inf"), dtype=torch.float32, device=queries.device)
    idx = torch.full((q, kk), offset + n, dtype=torch.int64, device=queries.device)
    take = min(kk, n)
    if take:
        if streaming if streaming is not None else use_streaming_knn(
                n, n_queries=q, dtype=shard_rows.dtype):
            from retrieval_fuse_tpu_torch.ops.streaming_knn import streaming_knn_sims
            s, i = streaming_knn_sims(queries, shard_rows, take)
        else:
            from retrieval_fuse_tpu_torch.ops.topk import TOPK_MAX_K, topk
            scores = queries.float() @ shard_rows.float().T
            s, i = (topk if take <= TOPK_MAX_K else iterative_topk)(scores, take)
        sims[:, :take] = s
        idx[:, :take] = i.long() + offset
    return sims, idx


def merge_candidates(sims: torch.Tensor, idx: torch.Tensor, k: int):
    """Merge the shards' candidate lists, laid side by side in shard order
    ((Q, n_shards·kk) similarities and global indices): the top k by
    similarity, ties to the earlier column, which is the lower global index
    (shards hold ascending row blocks, each list is best first with ties
    to the lower row). Returns (int32 indices, sq_dists = max(2 - 2·cos, 0))."""
    from retrieval_fuse_tpu_torch.ops.topk import TOPK_MAX_K, topk
    select = topk if k <= TOPK_MAX_K else iterative_topk
    top_sims, pos = select(sims.contiguous(), k)
    top_idx = torch.gather(idx, 1, pos.long()).to(torch.int32)
    return top_idx, torch.clamp(2.0 - 2.0 * top_sims, min=0.0)


def sharded_exact_knn(queries: torch.Tensor, database, k: int, mesh,
                      streaming: bool | None = None):
    """Exact kNN with the database's rows sharded over the ranks of `mesh`
    (parallel/mesh.py), as the JAX package's sharded_exact_knn: every rank
    holds the same queries and moves only its own row block of `database`
    (which may stay on the host) to its device, takes a local top-k there
    (shard_candidates), all-gathers the (Q, kk) lists and merges them
    (merge_candidates), so every rank returns the same (int32 indices,
    sq_dists). Ties go to the lowest global index. `streaming` as in
    shard_candidates."""
    from retrieval_fuse_tpu_torch.parallel.mesh import gather_rows
    n = database.shape[0]
    start, stop = shard_bounds(n, mesh.size, mesh.rank)
    shard = torch.as_tensor(database[start:stop]).to(mesh.device)
    if shard.dtype in (torch.float32, torch.bfloat16):
        from retrieval_fuse_tpu_torch.ops.streaming_knn import knn_rows
        shard = knn_rows(shard)
    queries = queries.to(device=mesh.device, dtype=shard.dtype).contiguous()
    sims, idx = shard_candidates(queries, shard, k, start, -(-n // mesh.size), streaming)
    # (W, Q, kk) in rank order -> (Q, W·kk) in shard order
    all_sims = gather_rows(sims[None], mesh)
    all_idx = gather_rows(idx[None], mesh)
    q = queries.shape[0]
    return merge_candidates(all_sims.permute(1, 0, 2).reshape(q, -1),
                            all_idx.permute(1, 0, 2).reshape(q, -1), k)


def demote_same_scene(top_idx: torch.Tensor, sq_dists: torch.Tensor, db_scene_ids: torch.Tensor,
                      query_scene_ids: torch.Tensor, k: int):
    """Move hits from the query's own scene behind all other hits, keeping
    the order within each group (a stable sort on the same-scene flag, so
    ties keep distance order), then keep the first k."""
    is_same = db_scene_ids[top_idx.long()] == query_scene_ids[:, None]
    order = torch.argsort(is_same.to(torch.int32), dim=1, stable=True)
    return (torch.take_along_dim(top_idx, order, dim=1)[:, :k],
            torch.take_along_dim(sq_dists, order, dim=1)[:, :k])
