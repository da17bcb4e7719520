"""Serving CLI, as in the JAX package's serve.py: batch-process raw low-res
input chunks into 64³ TSDFs with the retrieve + refine engine, built from
the training artifacts: the dictionary's database rows become the kNN
database, the train-set target tiles the patch bank (row-aligned with the
database, zero-patch row included), and the two checkpoints the weights.

    python -m retrieval_fuse_tpu_torch.serve --config <resolved.yaml> \\
        --retrieval_ckpt runs/<exp>/ckpt_epoch=N \\
        --refinement_ckpt runs/<exp2>/ckpt_epoch=M \\
        --input <dir of <scene>.npz raw input chunks> --output <dir> \\
        [--batch_size 8] [--f32] [--fast | --variant V] [--obj] [--device cpu]

Writes <scene>_pred.npz (key "arr", float16 TSDF) and, with --obj,
<scene>_pred.obj: the native marching cubes of the float32 prediction at
0.75 target voxel (the val SceneHandler's visualize_target_chunk). The
checkpoints are in the port's layout (train/checkpoint.py). The dictionary
is the one `map` built for the retrieval checkpoint (retrieval/cli.py),
found where utils/misc.get_tree_path puts it, relative to the working
directory.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch

from retrieval_fuse_tpu_torch.data import SceneHandler, PatchedSceneDataset
from retrieval_fuse_tpu_torch.device import resolve_device
from retrieval_fuse_tpu_torch.train.checkpoint import load_checkpoint
from retrieval_fuse_tpu_torch.utils.misc import get_tree_path

def code_geometry(code: str) -> tuple[int, int]:
    """(patch size, context) of a retrieval network code such as "2+1",
    "4+2N", "16+4V2" or "pc_32+8"."""
    size, ctx = code.removeprefix("pc_").split("+")
    return int(size), int(re.match(r"\d+", ctx).group())


def dictionary_patch_size(database: np.ndarray) -> int:
    """The target patch size the dictionary was built with, from its first
    row's stored extent (every row, the zero-patch row too, stores an
    unpadded [x0, x1, ...] extent of that size)."""
    if database.shape[0] == 0:
        raise ValueError("empty dictionary database")
    return int(database[0, 2] - database[0, 1])


def build_patch_bank_from_database(database: np.ndarray, scene_list, dataset_train,
                                   patch_size: int | None = None) -> np.ndarray:
    """(N_rows, ps, ps, ps) raw df tiles row-aligned with the dictionary
    database: row i crops its unpadded train scene by the row's stored
    extent; the zero-patch row (scene index -1) becomes a trunc-filled tile,
    what compose pastes for it. `patch_size` defaults to the dictionary's
    own and must equal it."""
    n = database.shape[0]
    db_ps = dictionary_patch_size(database)
    patch_size = db_ps if patch_size is None else patch_size
    if db_ps != patch_size:
        raise ValueError(
            f"dictionary was built with {db_ps}³ target patches; the serving "
            f"engine folds {patch_size}³ tiles — build the map with the "
            f"RETRIEVAL patch geometry (patch_size_target={patch_size}), not "
            f"the refinement chunk geometry")
    bank = np.empty((n, patch_size, patch_size, patch_size), np.float32)
    cache: dict = {}
    trunc = float(dataset_train.scene_handler.target_trunc)
    for i in range(n):
        idx = int(database[i, 0])
        if idx < 0:
            bank[i] = trunc
            continue
        if idx not in cache:
            cache[idx] = dataset_train.get_scene_target(scene_list[idx])
        x0, x1, y0, y1, z0, z1 = database[i, 1:7].astype(np.int64)
        bank[i] = cache[idx][x0:x1, y0:y1, z0:z1]
    return bank


def verify_bank_database_alignment(config: dict, fenc_target_params: dict, database: np.ndarray,
                                   scene_list, dataset_train, n_sample: int = 8,
                                   min_cos: float = 0.999, device=None) -> float:
    """Refuse to serve wrong patches: re-embed a sample of the bank's source
    patches through the target encoder (on `device`) and require a cosine
    of at least `min_cos` with their stored database rows. A dictionary
    built from other scene data, ordering or normalisation than this config
    reads fails here. Returns the least cosine of the sample."""
    from retrieval_fuse_tpu_torch.models import get_retrieval_networks

    dev = resolve_device(device)
    rm = config["retrieval_model"]
    fenc_target = get_retrieval_networks(rm)[1]
    fenc_target.load_state_dict(fenc_target_params)
    fenc_target.to(dev).eval()
    ps, ctx = code_geometry(rm["network_target"])
    dtr = config["dataset_train"]
    t_mean = config.get("retrieval_norm", {}).get("target_mean", dtr["target_mean"])
    t_std = config.get("retrieval_norm", {}).get("target_std", dtr["target_std"])
    trunc = float(dataset_train.scene_handler.target_trunc)

    real_rows = np.flatnonzero(database[:, 0] >= 0)
    if real_rows.size == 0:
        return 1.0
    sample = real_rows[np.linspace(0, real_rows.size - 1,
                                   min(n_sample, real_rows.size)).astype(int)]
    patches, rows = [], []
    for i in sample:
        scene = scene_list[int(database[i, 0])]
        vol = np.pad(dataset_train.get_scene_target(scene).astype(np.float32),
                     ctx, constant_values=trunc)
        x0, x1, y0, y1, z0, z1 = database[i, 1:7].astype(np.int64)
        # stored extents are unpadded: in the padded volume the patch spans
        # [x0, x1 + 2·ctx), as the dataset slices its padded scenes
        patch = vol[x0: x1 + 2 * ctx, y0: y1 + 2 * ctx, z0: z1 + 2 * ctx]
        if patch.shape != (ps + 2 * ctx,) * 3:
            raise ValueError(
                f"bank/database geometry mismatch at row {i}: patch {patch.shape} "
                f"vs encoder input {(ps + 2 * ctx,) * 3}")
        patches.append((patch - t_mean) / t_std)
        rows.append(database[i, 7:])
    x = torch.from_numpy(np.stack(patches)[..., None].astype(np.float32)).to(dev)
    with torch.inference_mode():
        z = fenc_target(x).reshape(x.shape[0], -1).float()
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=1, keepdim=True), min=1e-12)
    cos = np.sum(z.cpu().numpy() * np.stack(rows), axis=1)
    worst = float(cos.min())
    if worst < min_cos:
        raise ValueError(
            f"serve-time bank/database row alignment check FAILED: re-embedded "
            f"target patches disagree with their database rows (min cosine "
            f"{worst:.4f} < {min_cos}); the dictionary was built from different "
            f"scene data, ordering, or normalization than this serving config")
    return worst


def build_engine_from_artifacts(config: dict, retrieval_ckpt, refinement_ckpt,
                                compute_dtype: torch.dtype = torch.bfloat16, device=None,
                                use_fused_decoder: bool = False,
                                use_pallas_attention: bool = False,
                                variant: str | None = None, verify_alignment: bool = True,
                                mesh=None):
    """The engine from on-disk artifacts: the dictionary (database.npy and
    index.json under the tree path of config + retrieval_ckpt, as `map`
    wrote them), the train scenes (the patch bank) and the two checkpoints
    (the refinement networks, and fenc_input from the retrieval one).
    `variant` is a variant string (inference.variant_engine_kwargs, e.g.
    inference.FAST_VARIANT) and overrides the two boolean options, which
    are the `fused` and `pallas` tokens. `verify_alignment`
    re-embeds a sample of the bank against its database rows first. The
    engine's query patches take the input encoder's geometry (its network
    code, e.g. 48³ windows at stride 32 for "pc_32+8") unless the config
    sets retrieval_patch_size_input / retrieval_patch_context_input.
    `mesh` serves each call data-parallel over its ranks, on its device."""
    from retrieval_fuse_tpu_torch.inference import RetrieveRefineEngine, variant_engine_kwargs

    dev = mesh.device if mesh is not None else resolve_device(device)
    config = dict(config)
    config["retrieval_ckpt"] = str(retrieval_ckpt)
    tree_path = Path(get_tree_path(config))
    database = np.load(tree_path / "database.npy")
    scene_list = json.loads((tree_path / "index.json").read_text())
    config["retrieval_patch_size_target"] = dictionary_patch_size(database)
    ps, ctx = code_geometry(config["retrieval_model"]["network_input"])
    config.setdefault("retrieval_patch_size_input", ps)
    config.setdefault("retrieval_patch_context_input", ctx)

    ds_train = PatchedSceneDataset("train", config["dataset_train"], SceneHandler("train", config))
    bank = build_patch_bank_from_database(database, scene_list, ds_train)

    retrieval_params = load_checkpoint(retrieval_ckpt)["params"]
    params = dict(load_checkpoint(refinement_ckpt)["params"])
    params["fenc_input"] = retrieval_params["fenc_input"]
    if verify_alignment:
        verify_bank_database_alignment(config, retrieval_params["fenc_target"], database,
                                       scene_list, ds_train, device=dev)
    if variant is None:
        variant = "+".join(["base"] + ["fused"] * use_fused_decoder
                           + ["pallas"] * use_pallas_attention)
    return RetrieveRefineEngine(config, params, database[:, 7:], bank,
                                compute_dtype=compute_dtype, device=dev, use_feature_bank=True,
                                mesh=mesh, **variant_engine_kwargs(variant))


def serve_directory(engine, input_dir, output_dir, batch_size: int = 8,
                    write_obj: bool = False, scene_handler=None) -> list[str]:
    """Run every <scene>.npz raw input chunk (key "arr") through the engine
    in fixed-size batches (the tail batch padded with its last chunk) and
    write <scene>_pred.npz (float16 TSDF); with `write_obj`, also
    <scene>_pred.obj, the mesh of the float32 prediction that
    `scene_handler`.visualize_target_chunk makes (on the engine's device).
    Under an engine's mesh every rank runs every batch and rank 0 alone
    writes. Returns the served scene names."""
    from retrieval_fuse_tpu_torch.parallel.mesh import barrier, is_writer
    writer = is_writer(getattr(engine, "mesh", None))
    if write_obj and scene_handler is None:
        raise ValueError("write_obj needs the scene_handler whose voxel size sets the level")
    input_dir, output_dir = Path(input_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(input_dir.glob("*.npz"))
    done = []
    for start in range(0, len(files), batch_size):
        chunk_files = files[start: start + batch_size]
        vols = []
        for f in chunk_files:
            with np.load(f) as z:
                vols.append(z["arr"].astype(np.float32))
        batch = np.stack(vols)[..., None]
        if batch.shape[0] < batch_size:  # fixed shapes: pad the tail batch
            pad = batch_size - batch.shape[0]
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])
        pred = engine(batch)[: len(chunk_files), ..., 0].cpu().numpy()
        for f, vol in zip(chunk_files, pred):
            done.append(f.stem)
            if not writer:
                continue
            np.savez_compressed(output_dir / f"{f.stem}_pred.npz", arr=vol.astype(np.float16))
            if write_obj:
                scene_handler.visualize_target_chunk(vol.astype(np.float32),
                                                     output_dir / f"{f.stem}_pred.obj",
                                                     device=engine.device)
    barrier(getattr(engine, "mesh", None))
    return done


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--retrieval_ckpt", type=str, required=True)
    parser.add_argument("--refinement_ckpt", type=str, required=True)
    parser.add_argument("--input", type=str, required=True,
                        help="dir of <scene>.npz raw input chunks")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--K", type=int, default=None)
    parser.add_argument("--f32", action="store_true", help="serve in float32 (default bf16)")
    parser.add_argument("--obj", action="store_true", help="also write marching-cubes meshes")
    parser.add_argument("--fused_decoder", action="store_true")
    parser.add_argument("--pallas_attention", action="store_true")
    parser.add_argument("--variant", type=str, default=None,
                        help="variant string, e.g. 'fused+pallasp+topk1p' (overrides the "
                             "two boolean flags)")
    parser.add_argument("--fast", action="store_true",
                        help="serve with the shipped configuration (inference.FAST_VARIANT)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from retrieval_fuse_tpu_torch.parallel.mesh import initialize_from_environment, mesh_for_batch
    initialize_from_environment(args.device)

    from retrieval_fuse_tpu_torch.config import read_config
    from retrieval_fuse_tpu_torch.inference import FAST_VARIANT

    config = read_config(args.config)
    if args.K is not None:
        config["K"] = args.K
    config["no_retrievals"] = True  # the engine retrieves on the device
    variant = args.variant
    if args.fast and variant is None:
        variant = FAST_VARIANT
    engine = build_engine_from_artifacts(
        config, args.retrieval_ckpt, args.refinement_ckpt,
        compute_dtype=torch.float32 if args.f32 else torch.bfloat16, device=args.device,
        use_fused_decoder=args.fused_decoder, use_pallas_attention=args.pallas_attention,
        variant=variant, mesh=mesh_for_batch(args.batch_size, device=args.device))
    sh = SceneHandler("val", config) if args.obj else None
    done = serve_directory(engine, args.input, args.output, args.batch_size,
                           write_obj=args.obj, scene_handler=sh)
    print(f"served {len(done)} chunks -> {args.output}")
    return done


if __name__ == "__main__":
    main()
