"""Retrieve + refine serving engine, as in the JAX package's inference.py.

  input chunk -> unfold into retrieval patches -> Patch04 encoder -> exact
  kNN against the device-resident embedding database -> U-Net backbone ->
  K-way patch attention over the feature-bank rows of the top-k tiles ->
  final decoder -> 64³ TSDF

The feature bank holds the retrieval backbone's features of every bank
tile, computed once at engine build (or passed in), so serving gathers
features by index instead of re-encoding tiles.

Ported variant tokens: `base` (the plain modules), `fused` (accepted; the
plain decoder computes the same function), `pallasg2` (the gathered
attention kernel), `topk1p` (the single-pass top-k kernel), `streamknn` /
`denseknn` (force the kNN path). The streaming kNN kernel is auto-selected
at Q >= 8192 queries and N >= 16384 rows. The other JAX tokens raise
NotImplementedError. Not ported yet: the re-encode path (no feature bank),
multi-device serving (`mesh`), and the phibank / packed-row / decoder /
backbone variants.
"""

from __future__ import annotations

import numpy as np
import torch

from retrieval_fuse_tpu_torch.device import resolve_device
from retrieval_fuse_tpu_torch.models import build_modules
from retrieval_fuse_tpu_torch.ops.fold3d import fold3d
from retrieval_fuse_tpu_torch.ops.knn import iterative_topk, use_streaming_knn
from retrieval_fuse_tpu_torch.ops.patch_attention import (
    gathered_patch_attention, pack_tile_rows)
from retrieval_fuse_tpu_torch.ops.streaming_knn import streaming_knn_sims
from retrieval_fuse_tpu_torch.ops.topk import topk


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


class RetrieveRefineEngine:
    """End-to-end chunk server: raw low-res df chunks in, 64³ TSDF out."""

    def __init__(self, config: dict, params: dict, database, patch_bank=None,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 feature_bank=None, gathered_attention: bool = False,
                 streaming_knn: bool | None = None, topk_impl: str = "iterative"):
        """
        params: {'fenc_input', 'unet_backbone', 'decoder', 'retrieval_backbone',
                 'patched_attention_block'} state_dicts (utils/flax_import for
                 JAX params, models.init_params for seeded random ones).
        database: (N, latent) L2-normalised embeddings, row i pairing with
                 bank tile i.
        patch_bank: (N, 16, 16, 16) raw df tiles; encoded once into the
                 feature bank unless `feature_bank` (N, 8, 8, 8, nf) is given.
        device: None or "cuda" -> the card (raises without CUDA); "cpu" only
                 when asked for.
        gathered_attention: run the attention as the gathered-row kernel
                 (ops/patch_attention) instead of the plain modules.
        streaming_knn: None auto-selects the streaming kNN kernel by query
                 count and database size (ops/knn.use_streaming_knn);
                 True/False forces it on/off.
        topk_impl: dense-path select: 'iterative' (plain k rounds of max +
                 mask) or 'single_pass' (the topk kernel).
        """
        self.device = resolve_device(device)
        self.compute_dtype = cd = compute_dtype
        self.K = config["K"]
        dtr = config["dataset_train"]
        # target tiles per chunk axis: dictionary rows tile the target chunk
        # at the retrieval target patch size (16 in every shipped config)
        self.n_fold = dtr["target_chunk_size"] // int(
            config.get("retrieval_patch_size_target", 16))
        self.r_patch_size = config.get("retrieval_patch_size_input", 2)
        self.r_ctx = config.get("retrieval_patch_context_input", 1)
        self.attn_extent = config.get("attn_patch_extent", 4) // 2
        self.attn_num_patch = config.get("attn_num_patch", 16)
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

        self.gathered_attention = bool(gathered_attention)
        if self.gathered_attention and not (
                config.get("attn_normalize", True) and config.get("attn_no_output_mapping", True)
                and config.get("attn_blend", True)):
            raise ValueError("the gathered attention kernel covers the shipped config "
                             "(normalize + no_output_mapping + blend)")
        if topk_impl not in ("iterative", "single_pass"):
            raise ValueError(f"topk_impl {topk_impl!r}: 'iterative' or 'single_pass'")
        self.topk_impl = topk_impl
        self.streaming_knn = streaming_knn

        self.database = _tensor(database, self.device, cd)
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

        if feature_bank is not None:
            self.feature_bank = _tensor(feature_bank, self.device, cd)
        elif patch_bank is not None:
            self.feature_bank = self._precompute_feature_bank(patch_bank)
        else:
            raise ValueError("pass patch_bank or feature_bank (the re-encode path "
                             "without a feature bank is not ported)")
        if self.gathered_attention:
            # one-time repack: bank rows become ready attention-patch rows
            self.feature_bank = pack_tile_rows(self.feature_bank, self.attn_extent).contiguous()

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

    def _unfold_input_patches(self, raw_input: torch.Tensor) -> torch.Tensor:
        """(B, ics, ics, ics, 1) raw df -> (B*R³, p, p, p, 1) retrieval-normalised
        overlapping patches, p = patch_size + 2*context, stride = patch_size;
        the context comes from trunc padding."""
        ps, ctx = self.r_patch_size, self.r_ctx
        x = torch.nn.functional.pad(raw_input, (0, 0) + (ctx, ctx) * 3,
                                    value=self.input_trunc)
        side = ps + 2 * ctx
        b, r = x.shape[0], raw_input.shape[1] // ps
        px = x.unfold(1, side, ps).unfold(2, side, ps).unfold(3, side, ps)
        # (b, r, r, r, 1, side, side, side) -> (b·r³, side, side, side, 1)
        patches = px.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(b * r ** 3, side, side, side, 1)
        return (patches - self.r_in_mean) / self.r_in_std

    def _use_streaming(self, n_queries: int) -> bool:
        if self.streaming_knn is not None:
            return bool(self.streaming_knn)
        return use_streaming_knn(self.database.shape[0], n_queries=n_queries)

    @torch.inference_mode()
    def embed_queries(self, raw_input: torch.Tensor) -> torch.Tensor:
        """(B, ics, ics, ics, 1) raw df -> (B·R³, latent) L2-normalised query
        embeddings in the compute dtype."""
        cd = self.compute_dtype
        z = self.fenc_input(self._unfold_input_patches(raw_input.float()).to(cd))
        z = z.reshape(z.shape[0], -1)
        return z / torch.clamp(torch.linalg.vector_norm(z.float(), dim=1, keepdim=True),
                               min=1e-12).to(cd)

    @torch.inference_mode()
    def retrieve(self, raw_input: torch.Tensor) -> torch.Tensor:
        """(B, ics, ics, ics, 1) raw df -> (B·R³, K) int32 bank rows."""
        z = self.embed_queries(raw_input)
        if self._use_streaming(z.shape[0]):
            return streaming_knn_sims(z.float().contiguous(), self._database_f32, self.K)[1]
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
        cd, b, k = self.compute_dtype, raw_input.shape[0], self.K
        x_in = ((raw_input.float() - self.in_mean) / self.in_std).to(cd)
        x_back = self.unet_backbone(x_in)
        if self.gathered_attention:
            blk = self.attention.attention_blocks_layer
            rows = gathered_patch_attention(
                self._tile_major_rows(x_back).contiguous(), self.feature_bank, top_idx,
                blk.theta, blk.phi, k, retrieval_mode=self.attn_retrieval_mode,
                sharpness=self.sharpness)
            fused = self._rows_to_volume(rows, b)
        else:
            bank = self.feature_bank
            feats = bank[top_idx.long()]                        # (B·R³, K, s, s, s, nf)
            feats = feats.transpose(0, 1).reshape(-1, *bank.shape[1:])
            volumes = fold3d(feats, self.n_fold, bank.shape[1])  # (K·B, S, S, S, nf), k-major
            x_retrieval = volumes.reshape(k, b, *volumes.shape[1:]).transpose(0, 1).reshape(
                b * k, *volumes.shape[1:])
            fused = self.attention(x_back, x_retrieval)
        pred = self.decoder(fused)
        return (pred.float() + 1.0) * self.target_trunc / 2.0

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
        return self.refine(x, self.retrieve(x))


#: the shipped serving configuration of the JAX package (inference.py:685)
FAST_VARIANT = "fused+pallasg2+topk1p"

#: JAX variant tokens the port does not implement yet -> where that work is listed
_NOT_PORTED = {
    "pallas": "ROADMAP Queue 2 item 4 (pallas_patch_attention)",
    "pallasp": "ROADMAP Queue 2 item 4 (pallas_patch_attention)",
    "flatg": "ROADMAP Queue 2 item 4 (pallas_patch_attention)",
    "pallasg": "ROADMAP Queue 2 item 5 (pallas_gathered_patch_attention)",
    "cdec": "ROADMAP Queue 2 item 6 (packed_decoder_tail)",
    "packed": "ROADMAP Queue 1 item 9 (packed decoders)",
    "dconv": "ROADMAP Queue 1 item 9 (packed decoders)",
    "fbb": "ROADMAP Queue 1 item 9 (fused backbone)",
    "phib": "ROADMAP Queue 1 item 8 (phibank attention)",
    "approxk": "ROADMAP Queue 1 item 8 (remaining variant tokens)",
}


def variant_engine_kwargs(variant: str) -> dict:
    """Variant string (tokens joined by '+', as in the JAX bench ladder) ->
    RetrieveRefineEngine keyword options. 'base' is all defaults; 'fused'
    is accepted and needs no option (the plain decoder computes the same
    function as the JAX FusedFinalDecoder)."""
    kwargs = {}
    for tok in variant.split("+"):
        if tok in ("base", "fused"):
            continue
        if tok == "pallasg2":
            kwargs["gathered_attention"] = True
        elif tok == "topk1p":
            kwargs["topk_impl"] = "single_pass"
        elif tok in ("streamknn", "denseknn"):
            kwargs["streaming_knn"] = tok == "streamknn"
        elif tok in _NOT_PORTED:
            raise NotImplementedError(
                f"variant token {tok!r} is not ported yet: {_NOT_PORTED[tok]}")
        else:
            raise ValueError(f"unknown variant token {tok!r} in {variant!r}")
    return kwargs
