# The serving half of an engine: the host-side checks, the captured CUDA
# graphs and their input staging, shared by the engine that
# compile_inference builds (deploy/compile.py) and the one that load_engine
# restores from a file (deploy/engine_io.py). It imports no model code, so a
# process that only loads an engine file never imports lfdtpu_torch.models.
#
# A subclass defines `_forward(x, vhw)`: tensors on the engine's device in,
# the detections out, with no host sync, no host data and no data-dependent
# shape, which is what a graph records.

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import tracing
from ..ops.conv_kernels import pair_conv3x3, stem_conv
from ..ops.group_norm import group_norm_relu
from ..ops.int8_conv import int8_conv
from ..ops.msda import ms_deform_attn, samples_taken
from ..ops.nms_kernel import nms_mask_sorted

_WARMUP_CALLS = 3  # eager calls before a capture
STAGING_SLOTS = 4  # most pinned input sets a graph keeps

_COUNTED = (nms_mask_sorted, stem_conv, pair_conv3x3, int8_conv,
            group_norm_relu)  # the kernel wrappers


def launch_counts():
    """{kernel wrapper name: launches so far in this process}."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


def count_engine_work(run, *args):
    """run(*args), and as counters (where tracing records) the K5 launches
    it made, `engine.gn_kernel`, and the multi-scale deformable attention's
    samples it took, `engine.msda_samples`, and K7 launches it made,
    `engine.msda_kernel` (each only where there are any)."""
    launches, samples, msda = group_norm_relu.launches, samples_taken(), ms_deform_attn.launches
    out = run(*args)
    tracing.count("engine.gn_kernel", lambda: group_norm_relu.launches - launches)
    if samples_taken() != samples:
        tracing.count("engine.msda_samples", samples_taken() - samples)
    if ms_deform_attn.launches != msda:
        tracing.count("engine.msda_kernel", ms_deform_attn.launches - msda)
    return out


def tf32_switches():
    """The process's TF32 switches for float32 math on the card: (matmul,
    cuDNN convolutions)."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@contextlib.contextmanager
def _tf32(switches):
    saved = tf32_switches()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = switches
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def frame_dtype(dtype):
    """The dtype a frame of `dtype` (torch or numpy) reaches the net in:
    uint8 (raw) or float32. Any other dtype is converted to float32 on
    arrival, as lfdtpu's jit does with float64 (JAX's default 32-bit mode);
    a captured engine holds one graph for each of the two."""
    if isinstance(dtype, torch.dtype):
        return torch.uint8 if dtype == torch.uint8 else torch.float32
    return torch.uint8 if np.dtype(dtype) == np.uint8 else torch.float32


def _copy(dst, src):
    """dst[...] = src (a CPU tensor view; an array or tensor), cast to dst's
    dtype in the same pass: torch's copy_, which spreads a copy of more than
    32768 elements over the intra-op threads (on the H100's host it stages a
    frame 20-30% sooner than np.copyto, PERF.md §6), or np.copyto where
    torch cannot wrap the array (read-only, a negative stride, a dtype
    torch lacks)."""
    if isinstance(src, np.ndarray) and src.flags.writeable:
        try:
            src = torch.from_numpy(src)
        except (TypeError, ValueError):
            pass
    if isinstance(src, torch.Tensor):
        dst.copy_(src)
    else:
        np.copyto(dst.numpy(), src, casting="unsafe")


def place_frames(buf, frames, extents=None):
    """Write frame i into buf[i, :h, :w] in one pass (cast to buf's dtype in
    that pass) and keep buf zero around it: the one writer of frames into
    an engine's input at its resolution, a captured engine's pinned slot
    or a plain zeroed buffer.

    buf: a (B, H, W, C) CPU tensor; frames: a (B, H, W, C) array or tensor,
    every row at the full extent, or a list of B (h, w, C) arrays of at most
    H x W. extents: the (B, 2) integer array of the extent last written
    into each row of buf, updated here; None for a zeroed buffer written
    once. Only the part of a row's last extent outside its new one is
    zeroed: a repeated extent zeros nothing. Returns the bytes written into
    buf, the frames' and the stale pad's."""
    pixel = buf.element_size() * buf.shape[3]
    if not isinstance(frames, list):
        _copy(buf, frames)
        if extents is not None:
            extents[:] = buf.shape[1:3]
        return buf.numel() * buf.element_size()
    written = 0
    for i, frame in enumerate(frames):
        h, w = frame.shape[:2]
        if extents is not None:
            lh, lw = (int(v) for v in extents[i])
            if lh > h:  # the rows below the new extent
                buf[i, h:lh, :lw].zero_()
                written += (lh - h) * lw * pixel
            if lw > w:  # right of it, above those rows
                buf[i, :min(h, lh), w:lw].zero_()
                written += min(h, lh) * (lw - w) * pixel
            extents[i] = (h, w)
        _copy(buf[i, :h, :w], frame)
        written += h * w * pixel
    return written


def as_frames(images):
    """An engine call's frames: a (B, H, W, C) array or tensor as it is, or
    a sequence of unpadded (h, w, C) frames as a list of arrays, each in
    the first one's dtype (as padding them into one array of it would)."""
    if isinstance(images, (torch.Tensor, np.ndarray)):
        return images
    frames = [np.asarray(f) for f in images]
    if frames:
        dtype = frames[0].dtype
        frames = [f if f.dtype == dtype else f.astype(dtype) for f in frames]
    return frames


@dataclasses.dataclass
class _Slot:
    """One set of pinned host buffers a call's inputs are staged in (the
    frames, and the valid extents with a numpy view), the extent last
    written into each of its frame rows (place_frames), and the event
    recorded after their copies to the device were enqueued."""
    host: torch.Tensor
    extents: np.ndarray
    vhw: torch.Tensor
    vhw_np: np.ndarray
    copied: torch.cuda.Event


@dataclasses.dataclass
class _Graph:
    """One captured graph, for frames of one dtype: its static input on the
    device, its pinned staging slots (oldest first), its outputs, the
    kernel launches it records, the MSDA samples it takes and its K7
    launches."""
    graph: torch.cuda.CUDAGraph
    inp: torch.Tensor
    slots: collections.deque
    out: object
    launches: dict
    samples: int
    msda_launches: int


def _clone(out):
    if isinstance(out, dict):
        return {k: v.clone() for k, v in out.items()}
    return out.clone()


class GraphRunner:
    """An engine's call: engine(images, valid_hw) -> detections on the
    engine's device, eager or replayed from a captured CUDA graph.

    images: (B, H, W, 3) numpy array or tensor at input_resolution, or a
    list of B unpadded (h, w, 3) arrays of at most that size (zero-padded
    into it as they are staged): raw uint8 frames, or float frames
    normalized on the host (any dtype but uint8 reaches the net as
    float32); valid_hw: (2,) shared or (B, 2) per-image unpadded extents.

    A captured runner holds one graph per frame dtype, uint8 and float32,
    each with its own static input and memory pool: the uint8 graph is
    captured by `_init_runner` (at build or load), the float32 one at the
    first float call (as jit traces again for a new input dtype). A CUDA
    tensor is copied into the static input; host frames are written once
    into a pinned staging slot (place_frames: the slot remembers each row's
    last extent and zeros only the stale pad) and copied asynchronously on
    the current stream. A graph keeps up to STAGING_SLOTS slots and takes
    the oldest whose copy is done, a new one while it has fewer, else
    waits for the oldest: a synchronous loop uses one slot, a pipelined
    stream (deploy/serving.py) as many as it runs ahead. The host does no
    allocation per call once a dtype's graph and slots exist. A call runs on the current stream; calls
    from different streams share the graphs' buffers, so the caller orders
    them. `captured_launches` holds how often the uint8 graph launches each
    hand-written kernel (their counters tick while a graph is captured, not
    when it replays).

    `tf32` holds the TF32 switches (tf32_switches) the engine's float32
    math runs under, whatever the calling process's: those of the process
    that built it, and a file carries them to the process that loads it.
    Its eager calls, warmup calls and captures run under them; a graph
    keeps the math it was captured with.

    Under a profiler session a call records the spans `engine.stage`
    (slot, pinned copy, H2D enqueue), `engine.replay` (timed on the device's stream)
    and `engine.clone`, or `engine.run` for an eager call (tracing.py), and
    the counters `engine.gn_kernel`: the K5 launches of the call's forward
    (the graph's, from its capture; an eager call's, from the wrapper's
    count), `engine.msda_samples`: the samples its multi-scale deformable
    attention takes (counted the same way; a net without MSDA counts
    none), `engine.msda_kernel`: its K7 launches (the same way; none on the
    CPU), and `engine.stage_bytes`: the bytes written into the pinned
    slot, the frames' and the stale pad zeroed (captured calls)."""

    # set by the subclass: device, batch_size, input_resolution, kernel_stem

    def _init_runner(self, captured, tf32=None):
        self.tf32 = tuple(tf32) if tf32 is not None else tf32_switches()
        self.captured = False
        self.captured_launches = None
        self.capture_seconds = None  # the uint8 graph's warmup and capture
        self._graphs = {}  # frame dtype -> _Graph
        if captured:
            t0 = time.perf_counter()
            self.captured_launches = self._capture(torch.uint8).launches
            self.capture_seconds = time.perf_counter() - t0
            self.captured = True

    def _forward(self, x, vhw):
        raise NotImplementedError

    def _run(self, x, vhw):
        with _tf32(self.tf32):
            return self._forward(x, vhw)

    # ---------------------------------------------------------- host side
    def _check_images(self, images):
        """Raise ValueError unless the call's frames (as_frames') are this
        engine's batch at its resolution, or unpadded frames within it."""
        eh, ew = self.input_resolution
        if isinstance(images, list):
            for f in images:
                if f.ndim != 3 or f.shape[0] > eh or f.shape[1] > ew:
                    raise ValueError(f"expected (h, w, C) frames of at most {eh}x{ew}, "
                                     f"got {tuple(f.shape)}")
            n = len(images)
        else:
            shape = tuple(images.shape)
            if len(shape) != 4 or shape[1:3] != self.input_resolution:
                raise ValueError(f"expected (B, {eh}, {ew}, C) images, got {shape}")
            n = shape[0]
        if n != self.batch_size:
            raise ValueError(f"engine batch_size is {self.batch_size}, got {n}")

    def _batch(self, images):
        """The call's frames as one checked (B, H, W, C) array or tensor at
        input_resolution: unpadded frames are written into a plain zeroed
        buffer in the dtype they reach the net in (place_frames)."""
        images = as_frames(images)
        self._check_images(images)
        if not isinstance(images, list):
            return images
        buf = torch.zeros((self.batch_size, *self.input_resolution, 3),
                          dtype=frame_dtype(images[0].dtype))
        place_frames(buf, images)
        return buf

    def _images(self, images):
        x = torch.as_tensor(self._batch(images))
        return x.to(self.device, frame_dtype(x.dtype), non_blocking=True)

    def _valid_hw(self, valid_hw):
        vhw = torch.as_tensor(valid_hw, dtype=torch.float32).to(self.device)
        return vhw.reshape(-1, 2).expand(self.batch_size, 2)

    # ------------------------------------------------------------ capture
    def _capture(self, dtype):
        """Capture the graph for frames of `dtype` (eager warmup calls on a
        side stream first); returns its _Graph."""
        if self.device.type != "cuda":
            raise RuntimeError(f"a captured engine needs a CUDA device, not {self.device}; "
                               "on the CPU build an eager one (captured=False)")
        dev, shape = self.device, (self.batch_size, *self.input_resolution, 3)
        with torch.cuda.device(dev):
            if not self._graphs:  # the valid extents' buffer, shared by the graphs
                self._vhw = torch.tensor([self.input_resolution] * self.batch_size,
                                         dtype=torch.float32, device=dev)
            inp = torch.zeros(shape, dtype=dtype, device=dev)
            # Eager calls on a side stream first: the kernels' build and
            # load at first use, cuDNN's plan selection and CUDA's lazy
            # module loading must all be over before the capture begins.
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_CALLS):
                    self._run(inp, self._vhw)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            before, samples, msda = launch_counts(), samples_taken(), ms_deform_attn.launches
            try:
                # thread_local: another thread's CUDA calls (a loader
                # pinning memory) do not fail this capture; no span records
                # inside it (a first float frame captures inside engine.stage)
                with tracing.paused(), torch.cuda.graph(graph,
                                                        capture_error_mode="thread_local"):
                    out = self._run(inp, self._vhw)
            except Exception as e:
                # never an eager engine in its place
                torch.cuda.synchronize(dev)
                raise RuntimeError(
                    f"capturing the engine into a CUDA graph failed: {e}") from e
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            g = _Graph(graph, inp, collections.deque(), out, launches,
                       samples_taken() - samples, ms_deform_attn.launches - msda)
            g.slots.append(self._new_slot(g))
            self._graphs[dtype] = g
            return g

    def _new_slot(self, g):
        host = torch.zeros(tuple(g.inp.shape), dtype=g.inp.dtype).pin_memory()
        vhw = torch.zeros((self.batch_size, 2)).pin_memory()
        return _Slot(host, np.zeros((self.batch_size, 2), np.int64), vhw, vhw.numpy(),
                     torch.cuda.Event())

    def _slot(self, g):
        """The staging slot for the next call of graph g (see the class)."""
        oldest = g.slots[0]
        if not oldest.copied.query() and len(g.slots) < STAGING_SLOTS:
            slot = self._new_slot(g)
        else:
            g.slots.popleft()
            oldest.copied.synchronize()
            slot = oldest
        g.slots.append(slot)
        return slot

    def _graph_for(self, images):
        """The graph for these frames' dtype, captured at its first use."""
        dtype = frame_dtype((images[0] if isinstance(images, list) else images).dtype)
        if self.kernel_stem and dtype != torch.uint8:
            raise ValueError("the stem kernel consumes raw uint8 frames")
        return self._graphs.get(dtype) or self._capture(dtype)

    def _load(self, g, images, valid_hw):
        """Put one call's inputs into graph g's static buffers, in stream
        order."""
        host_in = not (isinstance(images, torch.Tensor) and images.is_cuda)
        host_vhw = not (isinstance(valid_hw, torch.Tensor) and valid_hw.is_cuda)
        slot = self._slot(g) if host_in or host_vhw else None
        if host_in:
            tracing.count("engine.stage_bytes", place_frames(slot.host, images, slot.extents))
            g.inp.copy_(slot.host, non_blocking=True)
        else:
            g.inp.copy_(images)
        if host_vhw:
            slot.vhw_np[...] = np.asarray(valid_hw, np.float32).reshape(-1, 2)
            self._vhw.copy_(slot.vhw, non_blocking=True)
        else:
            self._vhw.copy_(valid_hw.reshape(-1, 2))
        if slot is not None:
            slot.copied.record()

    def __call__(self, images, valid_hw):
        if not self.captured:
            with tracing.span("engine.run", self.device):
                x, vhw = self._images(images), self._valid_hw(valid_hw)
                return count_engine_work(self._run, x, vhw)
        with torch.cuda.device(self.device):
            with tracing.span("engine.stage"):
                images = as_frames(images)
                self._check_images(images)
                g = self._graph_for(images)
                self._load(g, images, valid_hw)
            with tracing.span("engine.replay", self.device):
                g.graph.replay()
                tracing.count("engine.gn_kernel", g.launches["group_norm_relu"])
                if g.samples:
                    tracing.count("engine.msda_samples", g.samples)
                if g.msda_launches:
                    tracing.count("engine.msda_kernel", g.msda_launches)
            # Copies, so that call n's result survives call n + 1 (the
            # graph writes the same output tensors every replay): one small
            # device copy per output, max_det rows each (B x 100 x 7 floats
            # when packed, four such launches for the dict).
            with tracing.span("engine.clone"):
                return _clone(g.out)
