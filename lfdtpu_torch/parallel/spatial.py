# The image height split over a mesh's spatial axis: the port of what
# lfdtpu gets from `make_mesh(spatial=k)` and `spatial_image_sharding`
# (`lfdtpu/parallel/mesh.py:23-31,95-99`), where GSPMD inserts the halo
# exchanges of every conv. In torch one process drives one device and
# nothing inserts them: spatial_parallel(net, mesh) returns a copy of a net
# whose height-mixing modules run on this rank's rows and exchange what
# they need with the ranks that share its images.
#
# Rows. Of a map of global height H over S ranks, spatial rank s owns rows
# [floor(s*H/S), floor((s+1)*H/S)) (owned_rows): a pure function of
# (H, S, s), so every rank knows every rank's rows without asking. Only the
# height is split; the batch rows, W and the channels stay whole.
#
# The swapped modules (everything else in a net works row by row, so it
# runs on a strip as it is):
#   - convs, max pools and the kernels' modules (FusedStem's K2,
#     FusedFasterBlock's two K3 launches, Int8Unit's K4): each runs as it
#     is, with its own padding, on a window of input rows whose first row
#     is a multiple of its stride (kernel_window), and keeps the output
#     rows that read no padding row but a global edge's. The kernels keep
#     their contracts; a strip one of them cannot take raises from its
#     wrapper, nothing runs F.conv2d in its place;
#   - a float32 or float64 conv of a kernel larger than 1x1 computes only
#     its kept output rows, as an im2col GEMM over chunks of rows whose
#     unfolded input takes at most the window's bytes, or 64 MiB
#     (_conv_rows),
#     not through cuDNN: for fp32 (TF32 off) cuDNN's heuristics pick, at
#     some map shapes, an engine with a workspace of up to 2.1 GiB that is
#     also tens of times slower, and which shapes do follows no rule a
#     caller can read (tools/cudnn_workspace.py sweeps them). A strip's
#     heights differ from the whole map's, so a rank could hit such a shape
#     where one process does not, and need more memory than one process;
#     the GEMM's memory is a share of the window's whatever the shape.
#     bf16 convs stay on cuDNN;
#   - the nearest-exact upsample: output row i reads input row
#     floor((i + 0.5) * in / out) as torch's kernel rounds it (source_rows);
#   - GroupNorm: each rank's per-sample, per-group mean and centred sum
#     of squares over its rows, gathered and combined (Chan et al.'s
#     pairwise update: each rank's mean is the shift every rank then
#     holds), so no E[x^2] - E[x]^2 cancels (ROADMAP F8);
#   - the dense outputs: each level's strips gathered in rank order
#     (gather_levels) before DetectionNet.forward or Int8Chain.forward
#     flattens them, so row p of the result is one process's row p.
# BatchNorm in eval mode needs nothing. The net must be in eval mode: a
# training BatchNorm would take a strip's moments (lfdtpu never trains over
# a spatial mesh either).
#
# Collectives. Every exchange is one all_gather over the spatial group of
# each rank's first and last rows, padded to sizes every rank computes
# from (H, S) alone; each rank picks the rows its window needs, whichever
# rank owns them (at the deepest levels a rank owns one row or none, and a
# window may reach past its neighbour). No point-to-point send or recv.
# Every rank takes part in every collective in the same order, an empty
# strip too: the modules run in the net's order on every rank.
#
# The plan. A swapped module needs its input's global height, which a strip
# does not tell. So a SpatialNet runs a meta-device twin of the net (no
# memory, no arithmetic, no kernel launch) once per input shape, its
# swappable modules hooked to record each call's global height in call
# order; a forward then hands each swapped call its record in turn, and
# checks it. The twin and the copy share one object graph's structure:
# the copy shares every parameter and buffer with the net it was made
# from (its weights stay the net's, at no memory), the twin holds meta
# tensors of their shapes.

from __future__ import annotations

import copy
import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import tracing
from ..deploy.int8_net import Int8Chain, Int8Unit
from ..deploy.kernel_net import FusedFasterBlock, FusedStem
from ..models.detector import DetectionNet
from ..models.necks import NearestUpsample

__all__ = ["owned_rows", "out_height", "needed_rows", "kernel_window", "source_rows",
           "upsample_rows", "SpatialNet", "spatial_parallel"]


# --------------------------------------------------------------------------
# Rows: pure functions of the heights, the ranks and the window
# --------------------------------------------------------------------------

def owned_rows(height, parts, index):
    """[lo, hi): the rows of a map of `height` rows that rank `index` of
    `parts` owns."""
    return index * height // parts, (index + 1) * height // parts


def out_height(height, kernel, stride, pad):
    """The output height (or width) of a conv or pool (dilation 1, floor
    mode)."""
    return (height + 2 * pad - kernel) // stride + 1


def needed_rows(out_lo, out_hi, height, kernel, stride, pad):
    """[a, b): the input rows that output rows [out_lo, out_hi) of a conv
    or pool read: output row i reads rows i*stride - pad ... i*stride - pad
    + kernel - 1, clipped to [0, height). (0, 0) for no output row."""
    if out_hi <= out_lo:
        return 0, 0
    return (max(out_lo * stride - pad, 0),
            min((out_hi - 1) * stride - pad + kernel, height))


def kernel_window(out_lo, out_hi, height, kernel, stride, pad):
    """(r0, r1, j0): the input rows [r0, r1) to run a conv or pool on, as it
    is with its own padding, so that its local output rows j0 ... j0 +
    (out_hi - out_lo) - 1 are global output rows out_lo ... out_hi - 1,
    computed as on the whole map. r0 is a multiple of the stride (the
    local output grid is the global one) and lies ceil(pad / stride)
    outputs before out_lo, or at the global edge 0: the kept outputs read
    no padding row of a window edge that is not a global edge. (0, 0, 0)
    for no output row."""
    if out_hi <= out_lo:
        return 0, 0, 0
    r0 = stride * max(0, out_lo - -(-pad // stride))
    r1 = min(height, (out_hi - 1) * stride - pad + kernel)
    return r0, r1, out_lo - r0 // stride


_SOURCE_ROWS = {}


def source_rows(in_height, out_height_, dtype=torch.float32, device="cpu"):
    """The input row that each output row of a nearest-exact resize from
    in_height to out_height_ rows reads, as torch's kernel computes it for
    data of `dtype` on `device`: min(floor((i + 0.5) * in / out), in - 1)
    in float arithmetic (double for float64 data), which at some sizes
    lands one row below the exact quotient (7 of 1600 size pairs up to 40).
    A list of ints, read off torch's own resize of an index map; cached."""
    map_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    key = (in_height, out_height_, map_dtype, str(device))
    if key not in _SOURCE_ROWS:
        rows = torch.arange(in_height, dtype=map_dtype, device=device).view(1, 1, -1, 1)
        rows = F.interpolate(rows, size=(out_height_, 1), mode="nearest-exact")
        _SOURCE_ROWS[key] = [int(v) for v in rows.flatten().tolist()]
    return _SOURCE_ROWS[key]


def upsample_rows(out_lo, out_hi, in_height, out_height_, dtype=torch.float32, device="cpu"):
    """[a, b): the input rows that output rows [out_lo, out_hi) of a
    nearest-exact resize read (source_rows). (0, 0) for no output row."""
    if out_hi <= out_lo:
        return 0, 0
    src = source_rows(in_height, out_height_, dtype, device)
    return src[out_lo], src[out_hi - 1] + 1


# --------------------------------------------------------------------------
# The spatial axis as the swapped modules see it: rows, records, collectives
# --------------------------------------------------------------------------

def _wire(t, nchw):
    """t as the contiguous tensor every rank sends alike: an NCHW map as
    NHWC (a view of a channels_last one; the ranks' memory formats may
    differ), a 16-bit float as its bytes (whatever 16-bit types a backend
    takes); and the inverse of both."""
    w = (t.permute(0, 2, 3, 1) if nchw else t).contiguous()
    shape, dtype = w.shape, t.dtype
    if dtype in (torch.bfloat16, torch.float16):
        w = w.reshape(-1).view(torch.uint8)

    def back(u):
        if dtype in (torch.bfloat16, torch.float16):
            u = u.view(dtype).reshape(shape)
        return u.permute(0, 3, 1, 2) if nchw else u

    return w, back


def _zero_rows(t, dim, n):
    shape = list(t.shape)
    shape[dim] = n
    return t.new_zeros(shape)


def _pad_rows(t, dim, before, after):
    parts = ([_zero_rows(t, dim, before)] if before else []) + [t] + \
        ([_zero_rows(t, dim, after)] if after else [])
    return torch.cat(parts, dim) if len(parts) > 1 else t


class Strips:
    """The spatial axis of one mesh as a spatial net's swapped modules see
    it: this rank's place, the plan's records and the collectives. One
    object is shared by every swapped module of a SpatialNet.

    Under a profiler session each collective records the span
    `spatial.all_gather`, timed on the device's stream too, and adds one to the
    counter `spatial.collectives` (tracing.py): they tell the exchanges'
    cost from the compute's."""

    def __init__(self, mesh):
        self.parts, self.index, self.group = mesh.spatial, mesh.spatial_rank, mesh.spatial_group
        self.records = None
        self.cursor = 0

    def owned(self, height, index=None):
        return owned_rows(height, self.parts, self.index if index is None else index)

    # ------------------------------------------------------------ records
    def begin(self, records):
        self.records, self.cursor = records, 0

    def end(self):
        records, cursor = self.records, self.cursor
        self.records = None
        if cursor != len(records):
            raise RuntimeError(f"the spatial net ran {cursor} swapped calls, its plan "
                               f"{len(records)}")

    def take(self, kind):
        """(the next record, whether it is the net's first swapped call,
        whose input the caller cut to its window) for a swapped call of
        `kind`."""
        if self.records is None:
            raise RuntimeError(f"a {kind} of a spatial net called outside SpatialNet.forward")
        if self.cursor >= len(self.records):
            raise RuntimeError("the spatial net made more swapped calls than its plan")
        planned, value = self.records[self.cursor]
        if planned != kind:
            raise RuntimeError(f"swapped call {self.cursor} is a {kind}, its plan says "
                               f"{planned}")
        self.cursor += 1
        return value, self.cursor == 1

    # -------------------------------------------------------- collectives
    def all_gather(self, t, nchw=False):
        """Every spatial rank's `t` (equal shapes; an NCHW map with nchw),
        in rank order."""
        w, back = _wire(t, nchw)
        parts = [torch.empty_like(w) for _ in range(self.parts)]
        with tracing.span("spatial.all_gather", w.device):
            dist.all_gather(parts, w, group=self.group)
        tracing.count("spatial.collectives")
        return [back(p) for p in parts]

    def window_rows(self, x, dim, height, windows, first):
        """This rank's input rows [a, b) = windows[self.index] of a map of
        `height` rows, from x, its owned rows (or, for the net's first
        swapped call, x already holds [a, b)). windows: [(a, b)] for every
        rank, (0, 0) for a rank that needs none. One all_gather of every
        rank's last `top` and first `bottom` rows, padded, where a window
        reaches beyond its rank's own rows; top and bottom are the most any
        rank's window reaches above and below its own rows, so each rank's
        rows from a rank before it lie in that rank's last `top` rows, and
        from a rank after it in its first `bottom`."""
        a, b = windows[self.index]
        if first:
            if x.shape[dim] != b - a:
                raise ValueError(f"the spatial net's input holds {x.shape[dim]} rows; this "
                                 f"rank's window is rows {a}-{b} of {height}")
            return x
        own = [self.owned(height, r) for r in range(self.parts)]
        lo, hi = own[self.index]
        if x.shape[dim] != hi - lo:
            raise ValueError(f"a strip of {x.shape[dim]} rows; this rank owns rows {lo}-{hi} "
                             f"of {height}")
        live = [r for r in range(self.parts) if windows[r][1] > windows[r][0]]
        top = max([own[r][0] - windows[r][0] for r in live] + [0])
        bottom = max([windows[r][1] - own[r][1] for r in live] + [0])
        if top == 0 and bottom == 0:  # every window lies in its rank's own rows
            return x.narrow(dim, a - lo, b - a) if b > a else x.narrow(dim, 0, 0)
        n = hi - lo
        send = []
        if top:
            send.append(_pad_rows(x.narrow(dim, n - min(n, top), min(n, top)), dim,
                                  top - min(n, top), 0))
        if bottom:
            send.append(_pad_rows(x.narrow(dim, 0, min(n, bottom)), dim, 0,
                                  bottom - min(n, bottom)))
        got = self.all_gather(torch.cat(send, dim), dim == 2)
        if b <= a:
            return x.narrow(dim, 0, 0)
        pieces, g = [], a
        while g < b:
            r = next(r for r in range(self.parts) if own[r][0] <= g < own[r][1])
            end = min(b, own[r][1])
            if r == self.index:
                pieces.append(x.narrow(dim, g - lo, end - g))
            elif r < self.index:  # its last `top` rows: slot t is row own[r][1] - top + t
                pieces.append(got[r].narrow(dim, g - (own[r][1] - top), end - g))
            else:  # its first `bottom` rows, after its `top` slot
                pieces.append(got[r].narrow(dim, top + g - own[r][0], end - g))
            g = end
        return torch.cat(pieces, dim) if len(pieces) > 1 else pieces[0]

    def gather(self, x, dim, height):
        """The whole map from every rank's owned rows (uneven strips padded
        to the longest, then trimmed), in rank order."""
        own = [self.owned(height, r) for r in range(self.parts)]
        longest = max(hi - lo for lo, hi in own)
        n = own[self.index][1] - own[self.index][0]
        got = self.all_gather(_pad_rows(x, dim, 0, longest - n), dim == 2)
        return torch.cat([got[r].narrow(dim, 0, hi - lo) for r, (lo, hi) in enumerate(own)],
                         dim)

    def gather_levels(self, outs):
        """DetectionNet's and Int8Chain's gather_levels hook: every level's
        NCHW strip of every output kind (a tuple of per-level lists) as the
        whole level map."""
        out = []
        for kind in outs:
            levels = []
            for t in kind:
                height, _ = self.take(_GATHER)
                levels.append(self.gather(t, 2, height))
            out.append(levels)
        return tuple(out)


_GATHER = "gather"  # the records of gather_levels


# --------------------------------------------------------------------------
# The swapped modules
# --------------------------------------------------------------------------

class _Swapped(nn.Module):
    """A net's module run on strips. `inner` is the net's own module (not
    a child: the copy shares it, and its mode and weights, with the net)."""

    kind = None
    dim = 2  # the height's dim: NCHW

    def __init__(self, inner, strips):
        super().__init__()
        self.__dict__["inner"] = inner
        self.__dict__["strips"] = strips

    def __getattr__(self, name):
        # what the net reads of the module (an Int8Unit's out_scale) is the
        # net's module's
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.__dict__["inner"], name)

    @staticmethod
    def record(m, args):
        """The plan's record of a call of the net's module m: its input's
        global height."""
        return args[0].shape[2]


def _window_rows(parts, height, geometry):
    """(output height, [kernel_window of each rank's owned output rows])."""
    k, s, p = geometry
    h_out = out_height(height, k, s, p)
    return h_out, [kernel_window(*owned_rows(h_out, parts, r), height, k, s, p)
                   for r in range(parts)]


class _Window(_Swapped):
    """A conv, a max pool or a kernel module, of `geometry(m)` (kernel,
    stride, pad) over the height: run as it is on its window of rows, then
    cropped to the owned output rows. `empty` is the output of a rank that
    owns no output row (nothing runs)."""

    @classmethod
    def record(cls, m, args):
        return args[0].shape[cls.dim], cls.geometry(m)

    @staticmethod
    def geometry(m):
        raise NotImplementedError

    def run(self, x, j0, n, *args):
        """Output rows j0 ... j0 + n - 1 of the module run on the window x."""
        return self.inner(x).narrow(self.dim, j0, n)

    def empty(self, x):
        raise NotImplementedError

    def forward(self, x, *args):
        st = self.strips
        (height, geometry), first = st.take(self.kind)
        if geometry != self.geometry(self.inner):
            raise RuntimeError(f"{self.kind}: planned as {geometry}, is "
                               f"{self.geometry(self.inner)}")
        h_out, wins = _window_rows(st.parts, height, geometry)
        x = st.window_rows(x, self.dim, height, [w[:2] for w in wins], first)
        lo, hi = st.owned(h_out)
        if hi == lo:
            return self.empty(x)
        return self.run(x, wins[st.index][2], hi - lo, *args)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


_UNFOLD_BYTES = 64 * 2 ** 20  # a chunk's unfolded input: at most this, or the window's bytes


def _conv_rows(conv, x, j0, n):
    """Output rows j0 ... j0 + n - 1 of the conv (groups 1) run as it is on
    the window x, as an im2col GEMM over chunks of output rows: each
    chunk's unfolded input takes at most _UNFOLD_BYTES or x's bytes,
    whichever is more, and each image's product is written in place into
    the output, NHWC memory (returned as its channels_last NCHW view)."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    ph, pw = conv.padding
    b, c, h, w = x.shape
    w_out = out_height(w, kw, sw, pw)
    # no gradient crosses a strip's collectives: the spatial net is eval only
    weight = conv.weight.detach().reshape(conv.out_channels, -1).t()
    bias = None if conv.bias is None else conv.bias.detach()
    row_bytes = b * c * kh * kw * w_out * x.element_size()  # one output row, unfolded
    rows = max(1, max(_UNFOLD_BYTES, x.numel() * x.element_size()) // row_bytes)
    out = x.new_empty((b, n, w_out, conv.out_channels))
    for a in range(0, n, rows):
        r = min(rows, n - a)
        top = (j0 + a) * sh - ph  # the chunk's input rows [top, bottom), zero outside x
        bottom = top + (r - 1) * sh + kh
        chunk = x.narrow(2, max(top, 0), min(bottom, h) - max(top, 0))
        if top < 0 or bottom > h:
            chunk = F.pad(chunk, (0, 0, max(-top, 0), max(bottom - h, 0)))
        cols = F.unfold(chunk, (kh, kw), padding=(0, pw), stride=(sh, sw))
        for i in range(b):
            y = out[i, a:a + r].view(r * w_out, -1)
            torch.mm(cols[i].t(), weight, out=y)
            if bias is not None:
                y += bias
        del chunk, cols  # before the next chunk's unfold: one chunk's buffers at a time
    return out.permute(0, 3, 1, 2)


class _Conv(_Window):
    kind = "Conv2d"

    def __init__(self, inner, strips):
        super().__init__(inner, strips)
        if inner.dilation != (1, 1) or isinstance(inner.padding, str) or \
                inner.padding_mode != "zeros":
            raise ValueError("a spatial conv takes dilation 1 and zero padding")

    @staticmethod
    def geometry(m):
        return m.kernel_size[0], m.stride[0], m.padding[0]

    def run(self, x, j0, n):
        c = self.inner
        if x.dtype in (torch.float32, torch.float64) and c.groups == 1 and \
                c.kernel_size != (1, 1):
            return _conv_rows(c, x, j0, n)
        return super().run(x, j0, n)

    def empty(self, x):
        c = self.inner
        return x.new_empty((x.shape[0], c.out_channels, 0,
                            out_height(x.shape[3], c.kernel_size[1], c.stride[1], c.padding[1])))


class _MaxPool(_Window):
    kind = "MaxPool2d"

    def __init__(self, inner, strips):
        super().__init__(inner, strips)
        if _pair(inner.dilation) != (1, 1) or inner.ceil_mode:
            raise ValueError("a spatial max pool takes dilation 1 and floor mode")

    @staticmethod
    def _both(m):
        return _pair(m.kernel_size), _pair(m.stride or m.kernel_size), _pair(m.padding)

    @staticmethod
    def geometry(m):
        return tuple(v[0] for v in _MaxPool._both(m))

    def empty(self, x):
        k, s, p = (v[1] for v in self._both(self.inner))
        return x.new_empty((x.shape[0], x.shape[1], 0, out_height(x.shape[3], k, s, p)))


class _Stem(_Window):
    """K2 (FusedStem: 3x3/s2 with its own 1-pixel zero padding) on a window
    of the raw uint8 frame."""

    kind = "FusedStem"

    @staticmethod
    def geometry(m):
        return 3, 2, 1

    def empty(self, x):
        return torch.empty((x.shape[0], 64, 0, (x.shape[3] + 1) // 2), dtype=torch.bfloat16,
                           device=x.device)


class _Pair(_Window):
    """A FasterBlock's two K3 launches (3x3/s1, each with its own 1-pixel
    padding) as one window of a 5-row kernel: 2 rows beyond the kept ones
    on either side, the residual the same extended rows."""

    kind = "FusedFasterBlock"

    @staticmethod
    def geometry(m):
        return 5, 1, 2

    def empty(self, x):
        return x.new_empty((x.shape[0], x.shape[1], 0, x.shape[3]))


class _Int8(_Window):
    """K4 (Int8Unit: kernel k, padding k // 2) on a window of NHWC int8
    rows. Its residual (the identity or the shortcut's output: owned rows
    of the output map) gets zero rows around it up to the window's output
    rows: the epilogue adds it there, and the rows it pads are the ones the
    crop drops."""

    kind = "Int8Unit"
    dim = 1

    @staticmethod
    def geometry(m):
        return m.kernel_size, m.stride, m.kernel_size // 2

    def run(self, x, j0, n, residual=None, residual_scale=None):
        if residual is not None:
            produced = out_height(x.shape[1], *self.geometry(self.inner))
            residual = _pad_rows(residual, 1, j0, produced - j0 - n)
        return self.inner(x, residual, residual_scale).narrow(1, j0, n)

    def forward(self, x8, residual=None, residual_scale=None):
        return super().forward(x8, residual, residual_scale)

    def empty(self, x):
        u = self.inner
        k, s, p = self.geometry(u)
        return torch.empty((x.shape[0], 0, out_height(x.shape[2], k, s, p), u.wpack.shape[0]),
                           dtype=torch.float32 if u.out_scale is None else torch.int8,
                           device=x.device)


def _upsample_windows(parts, h_in, h_out, dtype, device):
    """(torch's source row of every output row, [the rows each rank's owned
    output rows read])."""
    src = source_rows(h_in, h_out, dtype, device)
    return src, [upsample_rows(*owned_rows(h_out, parts, r), h_in, h_out, dtype, device)
                 for r in range(parts)]


class _Upsample(_Swapped):
    """The nearest-exact resize (NearestUpsample) to a global (H, W): its
    owned output rows read the input rows torch's index map names."""

    kind = "NearestUpsample"

    @staticmethod
    def record(m, args):
        return args[0].shape[2], int(args[1][0])

    def forward(self, x, target_hw):
        st = self.strips
        (h_in, h_out), first = st.take(self.kind)
        src, wins = _upsample_windows(st.parts, h_in, h_out, x.dtype, x.device)
        x = st.window_rows(x, 2, h_in, wins, first)
        lo, hi = st.owned(h_out)
        w_out = int(target_hw[1])
        if hi == lo:
            return x.new_empty((x.shape[0], x.shape[1], 0, w_out))
        a = wins[st.index][0]
        rows = torch.tensor([i - a for i in src[lo:hi]], device=x.device)
        return F.interpolate(x.index_select(2, rows), size=(hi - lo, w_out),
                             mode="nearest-exact")


class _GroupNorm(_Swapped):
    """nn.GroupNorm over the whole map. Each rank takes the per-sample,
    per-group mean and centred sum of squares (M2) of its rows; one
    all_gather gives every rank everyone's, and each rank's mean is the
    shift the combination takes them about (Chan et al.: the global mean,
    then the sum of the ranks' M2 plus n_r (mean_r - mean)^2), so no
    E[x^2] - E[x]^2 cancels (ROADMAP F8). Moments in float32 (float64 for
    a float64 input), combined in float64; y = x * a + b with a = rstd *
    weight and b = bias - mean * a, as torch's kernel computes it, cast to
    the input's dtype. The ranks' counts come from the planned height."""

    kind = "GroupNorm"

    def forward(self, x):
        st = self.strips
        height, _ = st.take(self.kind)
        gn = self.inner
        n_batch, c, rows, w = x.shape
        g = gn.num_groups
        stat = torch.float64 if x.dtype == torch.float64 else torch.float32
        per_row = (c // g) * w
        if rows:
            var, mean = torch.var_mean(x.to(stat).reshape(n_batch, g, -1), dim=2,
                                       unbiased=False)
        else:
            var = mean = x.new_zeros((n_batch, g), dtype=stat)
        got = torch.stack(st.all_gather(torch.stack([mean, var * (per_row * rows)], -1)))
        counts = torch.tensor([float(per_row * (hi - lo)) for lo, hi in
                               (st.owned(height, r) for r in range(st.parts))],
                              dtype=torch.float64, device=x.device)[:, None, None]
        means, m2s = got[..., 0].double(), got[..., 1].double()
        total = counts.sum()
        mean_all = (counts * means).sum(0) / total
        var_all = (m2s.sum(0) + (counts * (means - mean_all) ** 2).sum(0)) / total
        rstd = torch.rsqrt(var_all.to(stat) + gn.eps)
        scale = rstd.repeat_interleave(c // g, dim=1)
        if gn.affine:
            scale = scale * gn.weight.to(stat)
        shift = -mean_all.to(stat).repeat_interleave(c // g, dim=1) * scale
        if gn.affine:
            shift = shift + gn.bias.to(stat)
        return (x.to(stat) * scale[:, :, None, None] + shift[:, :, None, None]).to(x.dtype)


_SWAPS = {nn.Conv2d: _Conv, nn.MaxPool2d: _MaxPool, FusedStem: _Stem,
          FusedFasterBlock: _Pair, Int8Unit: _Int8, NearestUpsample: _Upsample,
          nn.GroupNorm: _GroupNorm}


def _swap_class(m):
    """The swapped class of a module of a type that reads across rows, or
    None."""
    return _SWAPS.get(type(m))


# --------------------------------------------------------------------------
# The copies: the spatial one, and the meta twin that plans it
# --------------------------------------------------------------------------

def _reachable(obj):
    """(modules, tensors) reachable from obj through modules' attributes,
    lists, tuples, dicts, bound methods and objects of this package (an
    Int8Chain's steps and their units)."""
    modules, tensors, seen, stack = [], [], set(), [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            tensors.append(o)
        elif isinstance(o, nn.Module):
            modules.append(o)
            stack.extend(o.__dict__.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, types.MethodType):
            stack.append(o.__self__)
        elif type(o).__module__.startswith("lfdtpu_torch.") and hasattr(o, "__dict__"):
            stack.extend(vars(o).values())
    return modules, tensors


def _meta(t):
    m = torch.empty_like(t, device="meta")
    return nn.Parameter(m, requires_grad=t.requires_grad) if isinstance(t, nn.Parameter) else m


def _input_rows(record, parts, index, dtype, device):
    """[r0, r1): the rows of the net's input that the call of `record`, the
    net's first swapped call, reads on rank `index`."""
    kind, value = record
    if kind == _Upsample.kind:
        return _upsample_windows(parts, *value, dtype, device)[1][index]
    if kind == _GroupNorm.kind:
        return owned_rows(value, parts, index)
    height, geometry = value
    return _window_rows(parts, height, geometry)[1][index][:2]


class SpatialNet(nn.Module):
    """A DetectionNet or an Int8Chain run with the image height split over
    a mesh's spatial axis (spatial_parallel).

    forward(x, height=None, **kwargs): x is this rank's input rows
    (input_rows) of its batch rows of the NHWC input of global height
    `height` (default: the height given at construction); returns what the
    module returns for the whole images, on every spatial rank (the level
    maps gathered before the flatten). kwargs go to the module (Int8Chain's
    capture: each unit's owned rows). `strips` holds the axis."""

    def __init__(self, module, twin, strips, height=None):
        super().__init__()
        self.module = module
        self.__dict__["twin"] = twin  # meta tensors: not a child
        self.strips = strips
        self.height = height
        self._plans = {}

    def train(self, mode=True):
        super().train(mode)
        self.twin.train(mode)
        return self

    def plan(self, shape, dtype):
        """The records of a forward on inputs of the global `shape`
        (B, H, W, C) and `dtype`: each swappable call of the twin, in
        order, as its swapped class records it, and each level map's
        height at the gather."""
        key = (tuple(int(v) for v in shape), dtype)
        if key not in self._plans:
            records, hooks = [], []

            def note(m, args):
                cls = _swap_class(m)
                records.append((cls.kind, cls.record(m, args)))

            def levels(outs):
                records.extend((_GATHER, t.shape[2]) for kind in outs for t in kind)
                return outs

            for m in _reachable(self.twin)[0]:
                if _swap_class(m) is not None:
                    hooks.append(m.register_forward_pre_hook(note))
            self.twin.gather_levels = levels
            try:
                with torch.inference_mode():
                    self.twin(torch.empty(key[0], dtype=dtype, device="meta"))
            finally:
                for h in hooks:
                    h.remove()
                del self.twin.gather_levels
            if not records or records[0][0] == _GATHER:
                raise ValueError("the net has no module that reads across rows")
            self._plans[key] = records
        return self._plans[key]

    def input_rows(self, shape, dtype, device="cpu"):
        """[r0, r1): the rows of inputs of the global NHWC `shape` (and
        `dtype`, on `device`) that this rank must be given: its first
        swapped module's window."""
        return _input_rows(self.plan(shape, dtype)[0], self.strips.parts, self.strips.index,
                           dtype, device)

    def forward(self, x, height=None, **kwargs):
        height = self.height if height is None else int(height)
        self.strips.begin(self.plan((x.shape[0], height) + tuple(x.shape[2:]), x.dtype))
        try:
            out = self.module(x, **kwargs)
        except BaseException:
            self.strips.records = None
            raise
        self.strips.end()
        return out


def spatial_parallel(net, mesh, height=None):
    """A copy of `net` (a DetectionNet, or an engine's Int8Chain) whose
    convs, max pools, nearest-exact upsamples, GroupNorms, fused kernel
    modules (K2, K3) and int8 units (K4) run on this rank's rows of the
    image height over `mesh`'s spatial axis, as a SpatialNet. The copy
    shares every parameter and buffer with `net` and calls the net's own
    modules; `net` itself is not changed. height: the inputs' global
    height where it is fixed (an engine's)."""
    if not isinstance(net, (DetectionNet, Int8Chain)):
        raise ValueError("spatial_parallel takes a DetectionNet or an Int8Chain, not "
                         f"{type(net).__name__}")
    strips = Strips(mesh)
    modules, tensors = _reachable(net)
    memo = {id(t): t for t in tensors}
    for m in modules:
        cls = _swap_class(m)
        if cls is not None:
            memo[id(m)] = cls(m, strips)
    module = copy.deepcopy(net, memo)
    module.gather_levels = strips.gather_levels
    twin = copy.deepcopy(net, {id(t): _meta(t) for t in tensors})
    return SpatialNet(module, twin, strips, height)
