"""Each slice of the KV-cached rollout as one replay of a CUDA graph: the
port's counterpart of the ``jax.lax.scan`` that runs a slice's pixels as one
device program in lvt_tpu/models/vt_incremental.py.

``SliceGraph`` captures one whole slice of ``SliceDecoder``: the slice's own
inputs (zl's projection, the codes and their embedding rows), then the 256
pixel steps of ``SliceDecoder.sample``. Every launch of the eager loop is in
the graph with the live length and the launch plan (kernels 2, 3, 4) that the
eager loop gives it, so a replay launches what the eager loop launches and
computes the same codes. ``VideoTransformer.sample_video`` replays one graph
per sampled slice on the card; the eager loop stays the CPU path and the
check the card tests and ``chip_smoke.py`` hold the graph against.

Capture. The static inputs (zl, the slice codes, the primed mask) are
buffers of the graph, copied into before each replay. One eager run of the
whole slice on a side stream comes first: it builds the kernels, sets up
cuBLAS, reaches every live length's launch plan (and the shared-memory
attribute each plan sets) and makes the quantization constant, so that
none of that happens while capturing. The capture then runs under
``torch.no_grad()`` on the same stream. A failure raises: nothing falls
back to the eager loop.

Launch counts. A replay does not run the wrappers, so the warm-up's and
the capture's counts are taken back out of every wrapper of
``ops._lib.COUNTED`` and kept apart (``warmup_launches``, ``launches``),
and each replay adds what the capture recorded: a count stays the number
of launches on the device that made the rollout's codes.

Random draws. A graph holds the generator state it draws from. The graph
owns a generator of its own for each stream, registered with it. At one
stream a replay copies the caller's generator state into it before and back
after, so the caller's generator advances as the eager loop would advance
it, and the same state gives the eager loop's draws. At S streams a replay
draws the S seeds of ``vt_incremental.stream_seeds`` from the caller's
generator, as the eager loop does, and sets each stream's generator to the
state of a generator seeded with its seed.

Streams. With ``streams`` S > 1 the graph has S parallel branches, one a
block of b / S rows, each captured on a CUDA stream of its own: the
capture stream makes the slice's code copy and embedding buffer, the S
streams wait for it (a fork), each runs its block's projection, embedding
rows and pixel loop, and the capture stream waits for all S (a join) before
the capture ends. The warm-up runs on the same S streams, so that what a
stream sets up at first use (cuBLAS's workspace among it) exists before the
capture. A branch launches the kernels of the mode at b / S rows.

Weights. The graph reads the weights, its set-up's copies of them and the
caches by address. ``graph_key`` names every decoder and predictor weight by
``data_ptr()`` and ``_version``, so weights changed in place or replaced
give another key and a new capture. ``SliceGraphSlot`` keeps a model's one
graph and holds the weights its key names, so an address in the key never
names another tensor. A graph is never replayed over weights that changed
after its capture.
"""

import contextlib
import ctypes
import time

import torch

from ..ops._lib import COUNTED
from .vt_incremental import SliceDecoder, stream_seeds


@contextlib.contextmanager
def launches_apart():
    """Launches counted by the wrappers inside the block are taken back out
    of their counts and yielded as {wrapper: launches}, filled at exit."""
    before = {fn: fn.launches for fn in COUNTED}
    took = {}
    try:
        yield took
    finally:
        for fn, n in before.items():
            if fn.launches != n:
                took[fn] = fn.launches - n
            fn.launches = n


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def graph_key(params, slice_shape, b: int, device, knobs: dict, temp: float, greedy: bool):
    """The key of a slice graph: (the decoder's and predictor's weights by
    address and version, then the configuration: slice shape, b, dtype,
    device, knobs (``SliceDecoder``'s, ``streams`` among them), greedy and
    the temperature where it is read)."""
    weights = tuple((t.data_ptr(), t._version)
                    for t in _leaves((params["decoder"], params["predictor"])))
    dtype = params["decoder"]["conv_w"].dtype
    return (weights, tuple(slice_shape), int(b), dtype, str(torch.device(device)),
            tuple(sorted(knobs.items())), bool(greedy), None if greedy else float(temp))


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The nodes of a captured graph kept with ``keep_graph=True``, counted by
    ``cuGraphGetNodes`` of libcuda."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    err = get_nodes(graph.raw_cuda_graph(), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes returned CUresult {err}")
    return count.value


class SliceGraph:
    """One slice of ``decoder`` captured as a CUDA graph, from the first
    slice's zl (b, t, h, w, d), codes sl (b, nc, t, h, w) and primed mask
    (thw,) bool on the card; at ``decoder.streams`` S > 1 in S parallel
    branches. Call it on each slice's inputs. ``nodes``: the graph's node
    count; ``warmup_out``: the codes its eager warm-up sampled from the
    first slice's inputs (on the branches' streams, from the graph's own
    generators)."""

    captures = 0  # graphs captured in this process
    captures_seconds = 0.0  # their warm-ups, captures and instantiations, host clock

    def __init__(self, decoder: SliceDecoder, zl, sl, primed, temp: float, greedy: bool):
        dev = zl.device
        self.decoder, self.temp, self.greedy = decoder, temp, greedy
        self.zl, self.sl, self.primed = zl.clone(), sl.clone(), primed.clone()
        n = decoder.streams
        self.gens = [None] * n if greedy else [torch.Generator(device=dev) for _ in range(n)]
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept to count its nodes
        for gen in self.gens:
            if gen is not None:
                self.graph.register_generator_state(gen)
        stream = torch.cuda.Stream(dev)
        # the branches' streams, made once for the warm-up and the capture
        self.streams = [torch.cuda.Stream(dev) for _ in range(n)] if n > 1 else None
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with launches_apart() as self.warmup_launches, torch.no_grad():
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.warmup_out = self._slice()  # the eager loop's codes of the first inputs
            torch.cuda.synchronize(dev)
        self.warmup_seconds = time.perf_counter() - t0  # of capture_seconds below
        with launches_apart() as self.launches, torch.no_grad():
            with torch.cuda.graph(self.graph, stream=stream):
                self.out = self._slice()
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.nodes = graph_nodes(self.graph)
        self.capture_seconds = time.perf_counter() - t0
        SliceGraph.captures += 1
        SliceGraph.captures_seconds += self.capture_seconds

    def _slice(self):
        zlproj, sl_flat, emb = self.decoder.inputs(self.zl, self.sl, self.streams)
        self.decoder.sample(zlproj, sl_flat, emb, self.primed, self.gens, self.temp, self.greedy,
                            self.streams)
        return sl_flat.reshape(self.sl.shape)

    def __call__(self, zl, sl, primed, gen=None):
        """The slice's codes (b, nc, t, h, w), sampled by one replay; ``gen``
        (temperature sampling; None: the default CUDA generator) advances as
        the eager loop advances it."""
        self.zl.copy_(zl)
        self.sl.copy_(sl)
        self.primed.copy_(primed)
        if not self.greedy:
            gen = gen if gen is not None else torch.cuda.default_generators[zl.device.index]
            if len(self.gens) == 1:
                self.gens[0].set_state(gen.get_state())
            else:
                for own, seed in zip(self.gens, stream_seeds(gen, len(self.gens), zl.device)):
                    own.set_state(torch.Generator(device=zl.device).manual_seed(seed).get_state())
        self.graph.replay()
        if not self.greedy and len(self.gens) == 1:
            gen.set_state(self.gens[0].get_state())
        for fn, n in self.launches.items():
            fn.launches += n
        return self.out.clone()


class SliceGraphSlot:
    """The slice graph of one model: kept until a slice of another
    configuration, or of weights changed since its capture, asks for its
    own, which replaces it. The slot holds the weights the graph's key names
    by address, so none of those addresses is freed and given to another
    tensor while the key stands."""

    def __init__(self):
        self.key, self.graph, self.weights = None, None, ()

    def get(self, params, c, slice_shape, zl, sl, primed, knobs: dict, temp: float,
            greedy: bool) -> SliceGraph:
        """The graph of this configuration, captured on these inputs if it is
        not the kept one. params: the netG tree; knobs: ``SliceDecoder``'s
        kv_dtype, weight_dtype, mm_dtype, attn_impl and streams."""
        key = graph_key(params, slice_shape, sl.shape[0], zl.device, knobs, temp, greedy)
        if key != self.key:
            self.key, self.graph, self.weights = None, None, ()  # its memory before the new one
            decoder = SliceDecoder(params, c, slice_shape, sl.shape[0], zl.device, **knobs)
            self.graph = SliceGraph(decoder, zl, sl, primed, temp, greedy)
            self.key = key
            self.weights = tuple(_leaves((params["decoder"], params["predictor"])))
        return self.graph
