"""Serve a directory of raw input chunks through the engine, as the JAX
package's serve.serve_directory does.

Not ported yet: building an engine from training artifacts
(build_engine_from_artifacts), the CLI, and OBJ mesh output (ROADMAP
Queue 1 item 2).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def serve_directory(engine, input_dir, output_dir, batch_size: int = 8) -> list[str]:
    """Run every <scene>.npz raw input chunk (key "arr") through the engine
    in fixed-size batches (the tail batch padded with its last chunk) and
    write <scene>_pred.npz (float16 TSDF). Returns the served scene names."""
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
            np.savez_compressed(output_dir / f"{f.stem}_pred.npz", arr=vol.astype(np.float16))
            done.append(f.stem)
    return done
