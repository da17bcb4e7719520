"""Host-side batching, as in the JAX package's data/loader.py: fixed-shape
batches (the last partial batch is padded by repeating its last item and
carries a `valid` count of its real rows), optionally shuffled and sharded
over processes, built by a background prefetch thread."""

from __future__ import annotations

import queue
import threading

import numpy as np

_LIST_KEYS = ("name", "scene")


def collate(items: list[dict], batch_size: int, valid: int | None = None) -> dict:
    """Stack item dicts into one batch of `batch_size` rows, padding by
    repeating the last item; `valid` is the number of real rows."""
    if valid is None:
        valid = len(items)
    if len(items) < batch_size:
        items = items + [items[-1]] * (batch_size - len(items))
    batch = {}
    for key, v0 in items[0].items():
        if isinstance(v0, np.ndarray):
            batch[key] = np.stack([it[key] for it in items], axis=0)
        elif key in _LIST_KEYS:
            batch[key] = [it[key] for it in items]
    batch["valid"] = valid
    return batch


def batch_iterator(dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                   seed: int = 0, prefetch: int = 2,
                   process_index: int = 0, process_count: int = 1):
    """Yield fixed-shape batches; optionally shuffled, optionally prefetched.

    With several processes, every process shuffles with the same seed and
    takes a contiguous shard of identical length (short shards wrap around
    to the front of the global order); wrapped filler rows are excluded
    from each batch's `valid` count."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n_real = len(order)
    if process_count > 1:
        shard_len = -(-len(order) // process_count)
        start = process_index * shard_len
        shard = order[start: start + shard_len]
        n_real = len(shard)
        if n_real < shard_len:
            shard = np.concatenate([shard, order[: shard_len - n_real]])
        order = shard
    if drop_last:
        order = order[: (len(order) // batch_size) * batch_size]
        n_real = min(n_real, len(order))
    if len(order) == 0:
        return

    def produce():
        for start in range(0, len(order), batch_size):
            idxs = order[start: start + batch_size]
            v = max(0, min(len(idxs), n_real - start))
            yield collate([dataset[int(i)] for i in idxs], batch_size, valid=v)

    if prefetch <= 0:
        yield from produce()
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    sentinel = object()
    err_holder = []

    def worker():
        try:
            for b in produce():
                q.put(b)
        except Exception as e:  # raised again on the consuming thread
            err_holder.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        b = q.get()
        if b is sentinel:
            break
        yield b
    t.join()
    if err_holder:
        raise err_holder[0]
