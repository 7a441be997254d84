# The one writer of frames into an engine's input (deploy/runner.py
# place_frames) on the CPU: sequences of frames written into one buffer, as
# a captured engine's pinned slot takes them call after call, each write
# held bit for bit to a zeroed buffer with the frame copied into its corner
# (what the predict API built on every call before the writer), and the
# bytes it reports held to the frames' bytes plus the stale pad it zeroed.
import numpy as np
import pytest
import torch

from lfdtpu_torch.deploy.runner import as_frames, place_frames

torch.set_num_threads(1)

H, W = 64, 96  # the buffer's (engine's) resolution

# name: the calls in turn, each a list of one (h, w) extent per batch row,
# or "full" for a (B, H, W, 3) array at the resolution
SEQUENCES = {
    "shrink_then_full": [[(H, W)], [(40, 70)], [(30, 70)], [(30, 50)], [(H, W)]],
    "height_then_width": [[(50, W)], [(H, 60)], [(20, 20)], [(20, 20)], [(H, W)]],
    "batch2_rows_apart": [[(H, W), (33, 47)], [(41, 90), (H, 12)], [(41, 90), (H, 12)],
                          [(10, W), (50, 60)], [(H, W), (H, W)]],
    "full_array_after_small": [[(20, 30), (H, W)], "full", [(25, 10), (5, 95)], "full"],
}

# (frame dtype, buffer dtype): raw frames into the uint8 slot, raw frames
# and host-normalized float64 frames into the float32 slot
DTYPES = [(np.uint8, np.uint8), (np.uint8, np.float32), (np.float64, np.float32)]


def _frame(rng, h, w, dtype):
    if dtype == np.uint8:
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return rng.randn(h, w, 3) * 100.0  # float64, rounded on the way in


def _stale(last, new):
    """Pixels of the last extent outside the new one."""
    (lh, lw), (h, w) = last, new
    return lh * lw - min(lh, h) * min(lw, w)


@pytest.mark.parametrize("src,dst", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_each_write_equals_a_zeroed_buffer_with_the_frame_copied_in(sequence, src, dst):
    calls = SEQUENCES[sequence]
    b = len(next(c for c in calls if c != "full"))
    buf = torch.from_numpy(np.zeros((b, H, W, 3), dst))
    extents = np.zeros((b, 2), np.int64)  # a new slot: all zeros, nothing written
    last = [(0, 0)] * b
    pixel = 3 * np.dtype(dst).itemsize
    rng = np.random.RandomState(len(sequence))
    for call in calls:
        if call == "full":
            frames = np.stack([_frame(rng, H, W, src) for _ in range(b)])
            hws = [(H, W)] * b
        else:
            frames = [_frame(rng, h, w, src) for h, w in call]
            hws = call
        want = np.zeros((b, H, W, 3), dst)
        for i, (h, w) in enumerate(hws):
            want[i, :h, :w] = frames[i]
        got = place_frames(buf, as_frames(frames), extents)
        assert np.array_equal(buf.numpy(), want), (sequence, call)
        assert buf.numpy().tobytes() == want.tobytes()  # bit for bit (float zero signs too)
        frame_px = sum(h * w for h, w in hws)
        stale_px = 0 if call == "full" else sum(_stale(l, n) for l, n in zip(last, hws))
        assert got == (frame_px + stale_px) * pixel, (sequence, call)
        assert extents.tolist() == [list(hw) for hw in hws]
        last = list(hws)


@pytest.mark.parametrize("view", ["reversed_channels", "read_only", "crop", "tensor"])
def test_frames_of_every_layout_are_written_the_same(view):
    """A frame torch cannot wrap (a negative stride, a read-only array:
    np.copyto writes it), a strided crop, or a CPU tensor: the same bytes
    as the slice copy, in a plain buffer written once (no extents)."""
    rng = np.random.RandomState(7)
    base = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    frame = {"reversed_channels": base[:50, :70, ::-1],
             "read_only": base[:50, :70].copy(),
             "crop": base[5:55, 10:80],
             "tensor": torch.from_numpy(base[:50, :70].copy())}[view]
    if view == "read_only":
        frame.flags.writeable = False
    want = np.zeros((1, H, W, 3), np.float32)
    want[0, :50, :70] = np.asarray(frame)
    buf = torch.zeros((1, H, W, 3))
    assert place_frames(buf, [frame] if view == "tensor" else as_frames([frame])) == \
        50 * 70 * 3 * 4
    assert np.array_equal(buf.numpy(), want)


def test_as_frames_casts_every_frame_to_the_first_ones_dtype():
    """Mixed dtypes in one call take the first frame's, as one padded array
    of it did; an array or tensor passes through untouched."""
    a = np.full((4, 5, 3), 7, np.uint8)
    b = np.full((3, 2, 3), 200.7)
    frames = as_frames([a, b])
    assert [f.dtype for f in frames] == [np.uint8, np.uint8]
    assert np.array_equal(frames[1], b.astype(np.uint8))
    batch = np.zeros((2, 4, 5, 3), np.float32)
    assert as_frames(batch) is batch
