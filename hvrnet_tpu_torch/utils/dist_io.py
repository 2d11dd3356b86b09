"""Result merging by part files for whole-video sharded inference
(counterpart of ``hvrnet_tpu/utils/dist_io.py``): each rank dumps its LOCAL
result list to ``part_<rank>.pkl``; rank 0 waits for every part (written
atomically) and concatenates them in rank order.  ``VIDSeqDataset.
get_indices`` deals whole videos to ranks in order, so rank order is global
frame order.  No collective: the ranks are separate processes that share a
directory.
"""
from __future__ import annotations

import os
import pickle
import time


def trim_to_local(results, dataset, rank: int):
    """Cut a rank's runner output down to its shard.

    The runner places detections at per-rank LOCAL frame ids (the dataset
    rebases ``frame_id`` in ``get_indices``), so a rank's frames occupy the
    leading ``local_frame_size_list[rank]`` slots of its result list."""
    return results[:dataset.local_frame_size_list[rank]]


def dump_part(results, tmpdir: str, rank: int) -> str:
    """Atomically persist one rank's local results as ``part_{rank}.pkl``."""
    os.makedirs(tmpdir, exist_ok=True)
    part = os.path.join(tmpdir, f"part_{rank}.pkl")
    with open(part + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(part + ".tmp", part)   # atomic: never seen half-written
    return part


def collect_results(tmpdir: str, world_size: int, total: int):
    """Concatenate the ranks' LOCAL part pickles in rank order, cut to
    ``total`` frames."""
    merged = []
    for r in range(world_size):
        with open(os.path.join(tmpdir, f"part_{r}.pkl"), "rb") as f:
            merged.extend(pickle.load(f))
    return merged[:total]


def wait_for_parts(paths, timeout: float = 3600.0, poll: float = 0.5):
    """Block until every rank's part file exists, or raise on timeout (the
    barrier of the merge)."""
    deadline = time.time() + timeout
    while True:
        missing = [p for p in paths if not os.path.isfile(p)]
        if not missing:
            return
        if time.time() > deadline:
            raise TimeoutError(
                f"timed out after {timeout:.0f}s waiting for rank part "
                f"files: {missing}")
        time.sleep(poll)
