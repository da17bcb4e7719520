"""Retrieve + refine serving engine, as in the JAX package's inference.py.

  input chunk -> unfold into retrieval patches -> Patch04 encoder -> exact
  kNN against the device-resident embedding database -> U-Net backbone ->
  K-way patch attention over the retrieved tiles' features -> final
  decoder -> 64³ TSDF

By default the feature bank holds the retrieval backbone's features of
every bank tile, computed once at engine build (or passed in), so serving
gathers features by index; with use_feature_bank=False the engine keeps the
raw tiles and re-encodes the retrieved ones on every call, as the training
forward does.

Every variant token of the JAX engine is ported (`variant_engine_kwargs`):
the attention paths `pallas`, `pallasp` (+ `flatg`), `pallasg`, `pallasg2`
and `phib`, the decoders `fused`, `packed`, `dconv` and `cdec`, the fused
backbone `fbb`, and the selects `topk1p`, `approxk`, `streamknn`,
`denseknn`. The streaming kNN kernel is auto-selected against N >= 16384
rows at Q >= 4096 queries in float32 and at Q >= 1024 in bf16.

With a `mesh` (parallel/mesh.py: one process per card), every rank is
called with the same batch, serves its contiguous B/W rows on its own card
and all-gathers the outputs in rank order, so every rank returns the whole
batch, as JAX's engine does with the batch sharded over its mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from retrieval_fuse_tpu_torch.device import resolve_device
from retrieval_fuse_tpu_torch.models import build_modules
from retrieval_fuse_tpu_torch.ops import decoder_tail as dt
from retrieval_fuse_tpu_torch.ops import patch_attention as pa
from retrieval_fuse_tpu_torch.ops.decoder_tail import CompactPackedDecoder
from retrieval_fuse_tpu_torch.ops.fold3d import fold3d, unfold3d, unfold3d_pad_stride
from retrieval_fuse_tpu_torch.ops.fused_backbone import FusedSuperres08Backbone
from retrieval_fuse_tpu_torch.ops.fused_decoder import (
    DecomposedPackedDecoder, FusedFinalDecoder, PackedFinalDecoder)
from retrieval_fuse_tpu_torch.ops.knn import iterative_topk, use_streaming_knn
from retrieval_fuse_tpu_torch.ops.streaming_knn import knn_rows, streaming_knn_sims
from retrieval_fuse_tpu_torch.ops.topk import TOPK_MAX_K, topk

#: attention paths: the plain modules, then the kernels' feeds
ATTENTIONS = ("modules", "patches", "packedrows", "gathered", "gathered2", "phibank")
#: decoders: the plain module, then the coarse-grid ones
DECODERS = {"modules": None, "fused": FusedFinalDecoder, "packed": PackedFinalDecoder,
            "decomposed": DecomposedPackedDecoder, "compact": CompactPackedDecoder}
#: dense-path selects; 'approx' (lax.approx_max_k at recall 1.0, exact) and
#: 'top_k' (lax.top_k) of the JAX engine are the plain tie-exact select here
TOPK_IMPLS = ("iterative", "single_pass", "approx", "top_k")


#: variant token -> attention path / decoder, in the JAX engine's precedence
ATTENTION_TOKENS = (("phib", "phibank"), ("pallasg2", "gathered2"), ("pallasg", "gathered"),
                    ("pallasp", "packedrows"), ("pallas", "patches"))
DECODER_TOKENS = (("cdec", "compact"), ("dconv", "decomposed"), ("packed", "packed"),
                  ("fused", "fused"))


#: the most query-patch voxels the engine unfolds and encodes in one go
QUERY_VOXELS = 1 << 25


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


class EngineGeometry(NamedTuple):
    """The engine's patch geometry, read from a config once."""

    t_patch_size: int  # dictionary rows tile the target chunk at this size
    n_fold: int  # target tiles per chunk axis
    attn_extent: int  # e: the attention patch's coarse extent
    attn_num_patch: int  # attention patches per chunk axis
    coarse_grid: int  # S: the decoder's coarse grid


def engine_geometry(config: dict) -> EngineGeometry:
    # the retrieval target patch size is 16 in every shipped config
    target = config["dataset_train"]["target_chunk_size"]
    t_patch_size = int(config.get("retrieval_patch_size_target", 16))
    return EngineGeometry(t_patch_size, target // t_patch_size,
                          config.get("attn_patch_extent", 4) // 2,
                          config.get("attn_num_patch", 16), target // 2)


def check_kernel_limits(config: dict, device, attention: str, decoder: str,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        topk_impl: str = "iterative") -> None:
    """Raise ValueError when an engine on `device` would launch a CUDA
    kernel whose limits `config` breaks, naming the kernel and the value:
    the attention kernels of paths `patches` / `packedrows`
    (patch_attention), `gathered` (v1) and `gathered2` (v2) take F = nf·e³
    in 1..1024 features a row, an F -> 128 -> 128 -> 128 -> 32 MLP, K in
    1..32 candidates and, the gathered ones, T in 1..512 rows a tile; the
    decoder tail (`compact`) takes nf in 1..64 and a coarse grid S <= 80;
    the topk kernel (`single_pass`, the dense kNN's select) takes K in
    1..32. Inside those limits every shape runs: the shipped ones on their
    own kernel instances, the others on the general ones. The limits are
    the constants the kernel wrappers check. On the CPU every path runs the
    plain versions, which take any width."""
    if torch.device(device).type != "cuda":
        return
    token = dict((v, t) for t, v in ATTENTION_TOKENS + DECODER_TOKENS)
    nf, k = config["nf"], config["K"]
    geo = engine_geometry(config)
    if attention in ("patches", "packedrows", "gathered", "gathered2"):
        e = geo.attn_extent
        t = (geo.attn_num_patch // geo.n_fold) ** 3
        gathered = attention in ("gathered", "gathered2")
        f = nf * e ** 3
        if (not 1 <= f <= pa.KERNEL_MAX_F or not 1 <= k <= pa.KERNEL_MAX_K
                or (gathered and not 1 <= t <= pa.KERNEL_MAX_T)):
            kernel = {"patches": "patch_attention", "packedrows": "patch_attention",
                      "gathered": "gathered_attention_v1",
                      "gathered2": "gathered_attention"}[attention]
            raise ValueError(
                f"variant token {token[attention]!r} (attention {attention!r}) runs the "
                f"{kernel} kernel, which takes F in 1..{pa.KERNEL_MAX_F} features a row, "
                f"hidden {pa.KERNEL_HIDDEN}, C = {pa.KERNEL_EMBED}, K in 1..{pa.KERNEL_MAX_K}"
                + (f", T in 1..{pa.KERNEL_MAX_T} rows a tile" if gathered else "")
                + f"; this config gives F = nf·e³ = {f}, K = {k}"
                + (f", T = {t}" if gathered else "")
                + "; serve it with another attention path or on the CPU")
    if decoder == "compact":
        s = geo.coarse_grid
        if not 1 <= nf <= dt.KERNEL_MAX_NF or s > dt.KERNEL_MAX_S:
            raise ValueError(
                f"variant token {token[decoder]!r} (decoder {decoder!r}) runs the "
                f"decoder_tail kernel, which takes nf in 1..{dt.KERNEL_MAX_NF} and S <= "
                f"{dt.KERNEL_MAX_S}; this config gives nf = {nf}, S = {s}; serve it "
                f"with another decoder or on the CPU")
    if topk_impl == "single_pass" and not 1 <= k <= TOPK_MAX_K:
        raise ValueError(
            f"variant token 'topk1p' (topk_impl 'single_pass') runs the topk kernel, which "
            f"takes k in 1..{TOPK_MAX_K}; this config gives K = {k}; serve it with another "
            f"select or on the CPU")


class RetrieveRefineEngine:
    """End-to-end chunk server: raw low-res df chunks in, 64³ TSDF out."""

    def __init__(self, config: dict, params: dict, database, patch_bank=None,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 feature_bank=None, use_feature_bank: bool = True,
                 attention: str = "modules", flat_gather: bool = False,
                 decoder: str = "modules", fused_backbone: bool = False,
                 streaming_knn: bool | None = None, topk_impl: str = "iterative",
                 mesh=None):
        """
        params: {'fenc_input', 'unet_backbone', 'decoder', 'retrieval_backbone',
                 'patched_attention_block'} state_dicts (utils/flax_import for
                 JAX params, models.init_params for seeded random ones).
        database: (N, latent) L2-normalised embeddings, row i pairing with
                 bank tile i.
        patch_bank: (N, 16, 16, 16) raw df tiles; encoded once into the
                 feature bank unless `feature_bank` (N, 8, 8, 8, nf) is given
                 or use_feature_bank is False (then kept and re-encoded per call).
        device: None or "cuda" -> the card (raises without CUDA); "cpu" only
                 when asked for.
        attention: 'modules' (the plain PatchedAttentionBlock), 'patches'
                 (patch_attention over gathered (N, K, F) patches; JAX
                 `pallas`), 'packedrows' (patch_attention over gathered
                 pre-packed bank rows; `pallasp`, with flat_gather `flatg`),
                 'gathered' / 'gathered2' (the fused-gather kernels v1 / v2;
                 `pallasg` / `pallasg2`), 'phibank' (no kernel: phi over the
                 bank precomputed, hard selection only; `phib`).
        decoder: 'modules', 'fused', 'packed', 'decomposed' (`dconv`) or
                 'compact' (the decoder-tail kernel; `cdec`).
        fused_backbone: the coarse-grid backbone (`fbb`; 'gcr', 8³ input).
        streaming_knn: None auto-selects the streaming kNN kernel by query
                 count and database size (ops/knn.use_streaming_knn);
                 True/False forces it on/off.
        topk_impl: dense-path select: 'iterative', 'approx' or 'top_k' (the
                 plain tie-exact select) or 'single_pass' (the topk kernel).
        mesh:    serve each call's batch data-parallel over the mesh's ranks
                 (parallel/mesh.py), on the mesh's device; the kernel limits
                 and crossovers apply to each rank's rows.
        """
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        check_kernel_limits(config, self.device, attention, decoder, compute_dtype, topk_impl)
        self.compute_dtype = cd = compute_dtype
        self.K = config["K"]
        dtr = config["dataset_train"]
        geo = engine_geometry(config)
        self.t_patch_size, self.n_fold = geo.t_patch_size, geo.n_fold
        self.r_patch_size = config.get("retrieval_patch_size_input", 2)
        self.r_ctx = config.get("retrieval_patch_context_input", 1)
        self.attn_extent, self.attn_num_patch = geo.attn_extent, geo.attn_num_patch
        self.attn_retrieval_mode = config.get("attn_retrieval_mode", True)
        self.nf = config["nf"]

        modules = build_modules(config)
        for name, module in modules.items():
            module.load_state_dict(params[name])
            module.to(device=self.device, dtype=cd).eval().requires_grad_(False)
        self.fenc_input = modules["fenc_input"]
        self.unet_backbone = modules["unet_backbone"]
        self.decoder = modules["decoder"]
        self.retrieval_backbone = modules["retrieval_backbone"]
        self.attention = modules["patched_attention_block"]
        self.sharpness = self.attention.attention_blocks_layer.sharpness

        if attention not in ATTENTIONS:
            raise ValueError(f"attention {attention!r}: one of {ATTENTIONS}")
        if attention != "modules" and not (
                config.get("attn_normalize", True) and config.get("attn_no_output_mapping", True)
                and config.get("attn_blend", True)):
            raise ValueError("the attention kernels cover the shipped config "
                             "(normalize + no_output_mapping + blend)")
        if attention == "phibank" and not self.attn_retrieval_mode:
            raise ValueError("phibank serving implements hard selection; the sharp-softmax "
                             "variant blends all K candidate rows")
        self.attention_path = attention
        # the engine owns these weights (loaded above): the kernels' operands
        # are packed at the first launch and kept
        pa.freeze_operands(self.attention.attention_blocks_layer.theta,
                           self.attention.attention_blocks_layer.phi)
        self.flat_gather = bool(flat_gather)
        if decoder not in DECODERS:
            raise ValueError(f"decoder {decoder!r}: one of {tuple(DECODERS)}")
        self.fused_decoder = None if DECODERS[decoder] is None else DECODERS[decoder](
            self.decoder.state_dict(), self.nf, cd).to(self.device)
        self.fused_backbone = None
        if fused_backbone:
            if dtr["input_chunk_size"] != 8 or config.get("layer_order", "gcr") != "gcr":
                raise ValueError("the fused backbone covers the 08-superresolution 'gcr' "
                                 "geometry")
            self.fused_backbone = FusedSuperres08Backbone(
                self.unet_backbone, self.nf, config.get("layer_order", "gcr"), cd).to(self.device)
        if topk_impl not in TOPK_IMPLS:
            raise ValueError(f"topk_impl {topk_impl!r}: one of {TOPK_IMPLS}")
        self.topk_impl = topk_impl
        self.streaming_knn = streaming_knn

        # in the layout the kNN kernel reads in place (its row pitch)
        self.database = knn_rows(_tensor(database, self.device, cd))
        # the kNN scores are float32 of the compute-dtype rows, as in JAX
        self._database_f32 = self.database.float()

        self.in_mean, self.in_std = dtr["input_mean"], dtr["input_std"]
        self.tgt_mean, self.tgt_std = dtr["target_mean"], dtr["target_std"]
        rm = config.get("retrieval_norm", {})
        self.r_in_mean = rm.get("input_mean", self.in_mean)
        self.r_in_std = rm.get("input_std", self.in_std)
        # the reference stores trunc in float16; keep its rounding
        self.input_trunc = float(np.float16(dtr["voxel_size_input"] * 3).astype(np.float32))
        self.target_trunc = float(np.float16(dtr["voxel_size_target"] * 3).astype(np.float32))

        self.feature_bank = self.patch_bank = None
        if feature_bank is not None:
            self.feature_bank = _tensor(feature_bank, self.device, cd)
        elif patch_bank is None:
            raise ValueError("pass patch_bank or feature_bank")
        elif use_feature_bank:
            self.feature_bank = self._precompute_feature_bank(patch_bank)
        else:
            self.patch_bank = _tensor(patch_bank, self.device, cd)
        if attention in ("packedrows", "gathered", "gathered2", "phibank"):
            if self.feature_bank is None:
                raise ValueError(f"attention {attention!r} requires the feature bank")
            # one-time repack: bank rows become ready attention-patch rows
            self.feature_bank = pa.pack_tile_rows(self.feature_bank, self.attn_extent).contiguous()
        self.phi_bank = self._precompute_phi_bank() if attention == "phibank" else None

    @torch.inference_mode()
    def _precompute_feature_bank(self, patch_bank, batch: int = 4096) -> torch.Tensor:
        """Encode every normalised bank tile once -> (N, 8, 8, 8, nf)."""
        tiles = torch.as_tensor(patch_bank)
        outs = []
        for start in range(0, tiles.shape[0], batch):
            chunk = _tensor(tiles[start:start + batch], self.device, self.compute_dtype)
            chunk = ((chunk.float() - self.tgt_mean) / self.tgt_std).to(self.compute_dtype)
            outs.append(self.retrieval_backbone(chunk[..., None]))
        return torch.cat(outs)

    @torch.inference_mode()
    def _precompute_phi_bank(self, batch: int = 131072) -> torch.Tensor:
        """Normalised phi features of every bank attention patch: (N, T, F)
        packed rows -> (N, T, C) float32, with the attention kernels' math
        (ops/patch_attention._mlp), so that serving scores match them."""
        n, t, f = self.feature_bank.shape
        rows = self.feature_bank.reshape(n * t, f)
        phi = self.attention.attention_blocks_layer.phi
        return torch.cat([pa.embed(rows[s:s + batch], phi)
                          for s in range(0, n * t, batch)]).reshape(n, t, -1)

    def _unfold_input_patches(self, raw_input: torch.Tensor) -> torch.Tensor:
        """(B, ics, ics, ics, 1) raw input -> (B*R³, p, p, p, 1) retrieval-normalised
        overlapping patches, p = patch_size + 2*context, stride = patch_size;
        the context comes from trunc padding (empty space, 0, for occupancy
        inputs, whose voxel size is 0)."""
        ps, ctx = self.r_patch_size, self.r_ctx
        patches = unfold3d_pad_stride(raw_input, ps + 2 * ctx, ctx, self.input_trunc, ps)
        return (patches - self.r_in_mean) / self.r_in_std

    def _use_streaming(self, n_queries: int) -> bool:
        if self.streaming_knn is not None:
            return bool(self.streaming_knn)
        return use_streaming_knn(self.database.shape[0], n_queries=n_queries,
                                 dtype=self.compute_dtype)

    @torch.inference_mode()
    def embed_queries(self, raw_input: torch.Tensor) -> torch.Tensor:
        """(B, ics, ics, ics, 1) raw input -> (B·R³, latent) L2-normalised query
        embeddings in the compute dtype. Items are unfolded and encoded a
        few at a time, at most QUERY_VOXELS patch voxels, so that large
        overlapping windows (64 of 48³ a 128³ chunk) and the encoder's
        activations on them never exist for the whole batch at once."""
        cd = self.compute_dtype
        side = self.r_patch_size + 2 * self.r_ctx
        per_item = (raw_input.shape[1] // self.r_patch_size) ** 3 * side ** 3
        step = max(1, QUERY_VOXELS // per_item)
        z = torch.cat([self.fenc_input(self._unfold_input_patches(
            raw_input[i:i + step].float()).to(cd)) for i in range(0, raw_input.shape[0], step)])
        z = z.reshape(z.shape[0], -1)
        return z / torch.clamp(torch.linalg.vector_norm(z.float(), dim=1, keepdim=True),
                               min=1e-12).to(cd)

    @torch.inference_mode()
    def retrieve(self, raw_input: torch.Tensor) -> torch.Tensor:
        """(B, ics, ics, ics, 1) raw df -> (B·R³, K) int32 bank rows."""
        z = self.embed_queries(raw_input)
        if self._use_streaming(z.shape[0]):
            # the compute-dtype rows: bf16 products are exact in the kernel's
            # float32 sums, so this is the dense path's function
            return streaming_knn_sims(z.contiguous(), self.database, self.K)[1]
        # float32 products of the compute-dtype values, as JAX's
        # dot(..., preferred_element_type=float32); a bf16 matmul would
        # return bf16 scores
        sims = z.float() @ self._database_f32.T
        if self.topk_impl == "single_pass":
            return topk(sims, self.K)[1]
        return iterative_topk(sims, self.K)[1]

    @torch.inference_mode()
    def refine(self, raw_input: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
        """Raw input + its (B·R³, K) bank rows -> (B, tcs, tcs, tcs, 1) TSDF."""
        b = raw_input.shape[0]
        x_in = ((raw_input.float() - self.in_mean) / self.in_std).to(self.compute_dtype)
        backbone = self.unet_backbone if self.fused_backbone is None else self.fused_backbone
        decoder = self.decoder if self.fused_decoder is None else self.fused_decoder
        pred = decoder(self._attend(backbone(x_in), top_idx, b))
        return (pred.float() + 1.0) * self.target_trunc / 2.0

    def _attend(self, x_back: torch.Tensor, top_idx: torch.Tensor, b: int) -> torch.Tensor:
        """Backbone features (B, S, S, S, nf) + retrievals -> fused features,
        through the engine's attention path."""
        path, k = self.attention_path, self.K
        blk = self.attention.attention_blocks_layer
        kw = dict(retrieval_mode=self.attn_retrieval_mode, sharpness=self.sharpness)
        if path == "phibank":
            return self._phibank_attention(x_back, top_idx)
        if path in ("gathered", "gathered2"):
            kernel = (pa.gathered_patch_attention if path == "gathered2"
                      else pa.gathered_patch_attention_v1)
            rows = kernel(self._tile_major_rows(x_back).contiguous(), self.feature_bank,
                          top_idx, blk.theta, blk.phi, k, **kw)
            return self._rows_to_volume(rows, b)
        if path == "packedrows":
            return self._packedrows_attention(x_back, top_idx)
        if path == "patches":
            if self.feature_bank is not None:
                attn_patches = self._pack_feats_for_attention(
                    self.feature_bank[top_idx.long()], b)
            else:
                attn_patches = self._pack_volumes_for_attention(self._reencode(top_idx, b))
            e, nf = self.attn_extent, self.nf
            xp = unfold3d(x_back, e).reshape(-1, nf * e ** 3)
            out = pa.patch_attention(xp.contiguous(), attn_patches.contiguous(), blk.theta,
                                     blk.phi, k, **kw)
            return fold3d(out.reshape(-1, e, e, e, nf), self.attn_num_patch, e)
        if self.feature_bank is not None:
            bank = self.feature_bank
            feats = bank[top_idx.long()]                        # (B·R³, K, s, s, s, nf)
            feats = feats.transpose(0, 1).reshape(-1, *bank.shape[1:])
            x_retrieval = self._regroup(fold3d(feats, self.n_fold, bank.shape[1]), b)
        else:
            x_retrieval = self._reencode(top_idx, b)
        return self.attention(x_back, x_retrieval)

    def _regroup(self, volumes: torch.Tensor, b: int) -> torch.Tensor:
        """(K·B, S, S, S, C) k-major -> (B·K, ...) k-fastest."""
        k = self.K
        return volumes.reshape(k, b, *volumes.shape[1:]).transpose(0, 1).reshape(
            b * k, *volumes.shape[1:])

    def _reencode(self, top_idx: torch.Tensor, b: int) -> torch.Tensor:
        """The path without a feature bank: gather the retrieved raw tiles,
        compose K volumes, normalise and re-encode -> (B·K, S, S, S, nf)."""
        tps, r, cd = self.t_patch_size, self.n_fold, self.compute_dtype
        tiles = self.patch_bank[top_idx.long()]                 # (B·R³, K, tps³)
        tiles = tiles.transpose(0, 1).reshape(-1, tps, tps, tps, 1)
        volumes = fold3d(tiles, r, tps)                         # (K·B, tcs³, 1)
        retrievals = self._regroup(
            ((volumes.float() - self.tgt_mean) / self.tgt_std).to(cd), b)
        feats = self.retrieval_backbone(unfold3d(retrievals, tps))
        return fold3d(feats, r, tps // 2)

    def _pack_feats_for_attention(self, feats: torch.Tensor, b: int) -> torch.Tensor:
        """(B·Rin³, K, s, s, s, nf) gathered feature tiles -> (B·R³, K, nf·e³)
        attention patches in unfold3d row order, one permute. Attention
        patch i per axis lives in fold tile i // t at within-tile patch
        i % t, t = s // e patches per tile axis; Rin·t must equal
        attn_num_patch (4 tiles x 4 in the shipped geometry)."""
        e, rin, k, nf = self.attn_extent, self.n_fold, self.K, self.nf
        s = feats.shape[2]
        t = s // e
        if rin * t != self.attn_num_patch:
            raise ValueError(f"fold tiles x patches per tile ({rin} x {t}) must equal "
                             f"attn_num_patch ({self.attn_num_patch})")
        f = feats.reshape(b, rin, rin, rin, k, t, e, t, e, t, e, nf)
        f = f.permute(0, 1, 5, 2, 7, 3, 9, 4, 6, 8, 10, 11)
        return f.reshape(b * (rin * t) ** 3, k, e ** 3 * nf)

    def _pack_volumes_for_attention(self, x_retrieval: torch.Tensor) -> torch.Tensor:
        """(B·K, S, S, S, nf) regrouped retrieval volumes -> (B·R³, K, nf·e³)
        attention patches, as PatchedAttentionBlock regroups them."""
        e, r, k, nf = self.attn_extent, self.attn_num_patch, self.K, self.nf
        pp = unfold3d(x_retrieval, e).reshape(-1, k, r ** 3, e, e, e, nf)
        return pp.permute(0, 2, 1, 3, 4, 5, 6).reshape(-1, k, nf * e ** 3)

    def _packedrows_attention(self, x_back: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
        """Gather pre-packed bank rows into the (Q·T, K, F) candidate layout
        (by a swap of K and T, or with flat_gather by one flat take at
        idx·T + t), then patch_attention over tile-major rows."""
        bank, k = self.feature_bank, self.K
        q, t_rows, f = top_idx.shape[0], bank.shape[1], bank.shape[2]
        xt = self._tile_major_rows(x_back)                       # (Q, T, F)
        if self.flat_gather:
            idx2 = (top_idx.long()[:, None, :] * t_rows
                    + torch.arange(t_rows, device=bank.device)[None, :, None])
            pp = bank.reshape(-1, f)[idx2.reshape(q * t_rows, k)]
        else:
            pp = bank[top_idx.long()].transpose(1, 2).reshape(q * t_rows, k, f)
        blk = self.attention.attention_blocks_layer
        out = pa.patch_attention(xt.reshape(q * t_rows, f).contiguous(), pp.contiguous(),
                                 blk.theta, blk.phi, k, retrieval_mode=self.attn_retrieval_mode,
                                 sharpness=self.sharpness)
        return self._rows_to_volume(out.reshape(q, t_rows, f), x_back.shape[0])

    def _phibank_attention(self, x_back: torch.Tensor, top_idx: torch.Tensor) -> torch.Tensor:
        """Attention with no serving-time kernel: theta embeds the backbone
        rows, the scores read the precomputed phi bank's (Q, K, T, C) rows,
        and the hard selection gathers exactly one candidate row per output
        row."""
        xt = self._tile_major_rows(x_back)                       # (Q, T, F)
        q, t_rows, f = xt.shape
        xf = pa.embed(xt.reshape(q * t_rows, f), self.attention.attention_blocks_layer.theta)
        pf = self.phi_bank[top_idx.long()]                       # (Q, K, T, C)
        s = torch.sum(xf.reshape(q, 1, t_rows, -1) * pf, dim=-1)  # (Q, K, T)
        s = s.transpose(1, 2).reshape(q * t_rows, self.K)
        switch = torch.relu(torch.amax(s, dim=1, keepdim=True))
        sel = pa.hard_selection(s).reshape(q, t_rows)
        src = torch.gather(top_idx.long(), 1, sel)               # (Q, T) bank rows
        rows = (src * t_rows + torch.arange(t_rows, device=src.device)[None, :]).reshape(-1)
        p_sel = self.feature_bank.reshape(-1, f)[rows]
        fused = xt.reshape(q * t_rows, f).float() * (1.0 - switch) + p_sel.float() * switch
        return self._rows_to_volume(fused.to(self.compute_dtype).reshape(q, t_rows, f),
                                    x_back.shape[0])

    def _tile_major_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, S, nf) feature volume -> (B·Rin³, t³, e³·nf) tile-major
        attention-patch rows (per spatial axis S = Rin·t·e)."""
        e, rin, nf = self.attn_extent, self.n_fold, self.nf
        b, s = x.shape[0], x.shape[1]
        t = s // rin // e
        v = x.reshape(b, rin, t, e, rin, t, e, rin, t, e, nf)
        v = v.permute(0, 1, 4, 7, 2, 5, 8, 3, 6, 9, 10)
        return v.reshape(b * rin ** 3, t ** 3, e ** 3 * nf)

    def _rows_to_volume(self, rows: torch.Tensor, b: int) -> torch.Tensor:
        """Inverse of _tile_major_rows."""
        e, rin, nf = self.attn_extent, self.n_fold, self.nf
        t = self.attn_num_patch // rin
        s = rin * t * e
        v = rows.reshape(b, rin, rin, rin, t, t, t, e, e, e, nf)
        v = v.permute(0, 1, 4, 7, 2, 5, 8, 3, 6, 9, 10)
        return v.reshape(b, s, s, s, nf)

    def __call__(self, raw_input_chunks) -> torch.Tensor:
        """(B, ics, ics, ics, 1) raw low-res df -> (B, tcs, tcs, tcs, 1) TSDF
        (float32, on the engine's device)."""
        x = _tensor(raw_input_chunks, self.device, torch.float32)
        if self.mesh is None:
            return self.refine(x, self.retrieve(x))
        from retrieval_fuse_tpu_torch.parallel.mesh import gather_rows
        x = x[self.mesh.rows(x.shape[0])]
        return gather_rows(self.refine(x, self.retrieve(x)), self.mesh)


#: the shipped serving configuration of the JAX package (inference.py:685)
FAST_VARIANT = "fused+pallasg2+topk1p"

#: every variant token of the JAX engine (inference.py:688-720)
VARIANT_TOKENS = ("base", "fused", "packed", "cdec", "dconv", "fbb", "pallas", "pallasp",
                  "pallasg", "pallasg2", "phib", "flatg", "topk1p", "approxk", "streamknn",
                  "denseknn")


def variant_engine_kwargs(variant: str) -> dict:
    """Variant string (tokens joined by '+', as in the JAX bench ladder and
    `serve --variant`) -> RetrieveRefineEngine keyword options, with the JAX
    engine's precedence: phib > pallasg2 > pallasg > pallasp > pallas for
    the attention, cdec > dconv > packed > fused for the decoder (packed
    implies fused), streamknn > denseknn, approxk > topk1p. 'base' is all
    defaults; an unknown token raises ValueError."""
    toks = set(variant.split("+"))
    unknown = toks - set(VARIANT_TOKENS)
    if unknown:
        raise ValueError(f"unknown variant token(s) {sorted(unknown)} in {variant!r}")

    def first(table, default):
        return next((value for tok, value in table if tok in toks), default)

    return dict(
        attention=first(ATTENTION_TOKENS, "modules"),
        flat_gather="flatg" in toks,
        decoder=first(DECODER_TOKENS, "modules"),
        fused_backbone="fbb" in toks,
        streaming_knn=first((("streamknn", True), ("denseknn", False)), None),
        topk_impl=first((("approxk", "approx"), ("topk1p", "single_pass")), "iterative"))
