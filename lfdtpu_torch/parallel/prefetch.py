# Host batches onto the device ahead of the step, the port of
# `lfdtpu/parallel/mesh.py:58-92::prefetch_to_device`. Under a data mesh the
# loader already yields this rank's rows (data.ShardedDatasetSampler), so
# they go to the rank's device as they are.
#
# On a CUDA device each batch's arrays are copied into pinned host memory
# and from there to the device with non_blocking copies on a side stream,
# `size` batches ahead, so the copies overlap the steps. The consumer's
# stream waits on the batch's copy event when the batch is handed out (a
# device-side wait, no host sync), and the device tensors are marked as used
# on that stream so the caching allocator does not hand their memory to a
# later copy too early.
#
# Shared-memory slots (data.ShmDataLoader): the asynchronous copy reads the
# pinned staging, never the slot, and `pin_memory()` has copied the slot out
# by the time it returns, so the slot goes back to its loader right then.
# The staging buffer is torch's: its host allocator reuses it only once the
# copy that reads it has completed.

from __future__ import annotations

import collections

import numpy as np
import torch

__all__ = ["prefetch_to_device", "BATCH_KEYS"]

BATCH_KEYS = ("images", "gt_bboxes", "gt_labels", "gt_mask")


def prefetch_to_device(batch_iterator, device, size=2, keys=BATCH_KEYS):
    """Wrap a host batch iterator: yields the batch dicts with `keys`
    replaced by tensors on `device` (a device, or a parallel.Mesh: its
    rank's device), copied `size` batches ahead.

    A shared-memory slot is released as soon as its arrays are copied out
    (on the CPU into new tensors; there is nothing to overlap)."""
    device = torch.device(getattr(device, "device", device))
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def put(batch):
        out = dict(batch)
        if not cuda:
            for k in keys:
                out[k] = torch.from_numpy(np.array(batch[k]))
        else:
            pinned = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).pin_memory()
                      for k in keys}
            with torch.cuda.stream(stream):
                for k in keys:
                    out[k] = pinned[k].to(device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            out["_copied"] = event
        loader = batch.get("_loader")
        if loader is not None:
            loader.release_slot(batch)
        return out

    def hand_out(out):
        if cuda:
            current = torch.cuda.current_stream(device)
            current.wait_event(out.pop("_copied"))
            for k in keys:
                out[k].record_stream(current)
        return out

    it = iter(batch_iterator)
    buf = collections.deque()

    def fill():
        batch = next(it, None)
        if batch is not None:
            buf.append(put(batch))
        return batch is not None

    while len(buf) < size and fill():
        pass
    while buf:
        yield hand_out(buf.popleft())
        fill()
