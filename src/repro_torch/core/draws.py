"""Every random input of one simulator round, as one record.

The reference derives its randomness from JAX PRNG keys (a 7-way split per
round, ``repro/core/simulator.py``). The port takes the numbers instead:
:func:`draw_round` fills a :class:`RoundDraws` from three ``torch.Generator``
streams, and a test can fill one from ``jax.random`` with the reference's
own key discipline, which makes the two packages take the same discrete
decisions. Shapes and dtypes are the reference's; the quantized
transport's rounding uniforms are one [N, P] draw, row i for client i, as
the reference's per-client-id streams are.

The streams: the first gives everything a static run draws; the second
the quantized transport's rounding uniforms; the third a temporal run's
process draws (``core/dynamics.py``): the initial fading state
(:class:`InitDraws`, drawn first) and each round's shadow-walk normals and
availability uniforms. As the reference's ``fold_in`` streams of its
channel key, the second and third leave the first as it is, so one seed
gives the same channels, Gumbel noise and batches under every transport,
and a temporal run with every process knob at zero sees the static run's.

A batched round of G cells reads one :class:`RoundDraws` with a leading
[G] on every field, stacked from each cell's own draws by
:func:`stack_draws`. A cell's draws are those of its own single run:
cells that share a seed and a :func:`draw_signature` may share one stream,
and a noise-free cell of a noisy group keeps its own stream (it draws no
AWGN, so its later draws differ from a noisy cell's) and reads a zero AWGN
row.

The sharded control plane (``control_plane="sharded"``) cannot take a
table of [N] rows a round: a shard holds only its own clients, and the
round asks for values at ids it learns inside the round (the K winners'
batch indices and rounding uniforms). Its randomness is an
:class:`IdDraws` source instead, which answers ``(round, stream, ids) ->
values``: ``source.round(t)`` gives the round's :class:`RoundStreams`, one
:class:`Stream` a role in the reference's split order (``chan``, ``sel``,
``batch``, ``noise``, ``asel``, ``abatch``), and ``stream.fold(i)`` a
sub-stream, as ``fold_in`` does to a key. A client's values depend only on
(source, round, stream, id), never on which other ids are asked, so a
shard draws its own rows and a mesh run equals the one-device run.
:class:`HashDraws` is the port's own source: a counter-based hash of
(seed, round, stream, id, element) in exact integer arithmetic, which gives
the same integers on the CPU and on the card. The receiver noise stays one
[P] draw a round, addressed by round and element, the same on every rank.
A sweep group's G sources are one :class:`CellDraws`, whose draws lead
with [G] (hash sources: one hash over the G keys).
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, NamedTuple, Optional, Sequence

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.aircomp import flat_awgn
from repro_torch.utils.device import resolve_device


class RoundDraws(NamedTuple):
    # the shapes of one run; a batched round's fields lead with [G]
    chan_normal: torch.Tensor             # [2, N, draw_sc] Rayleigh re/im normals
    shadow_normal: torch.Tensor           # [N, 1] shadowing normals
    sel_gumbel: Optional[torch.Tensor]    # [N] selection Gumbel (None: greedy)
    batch_idx: torch.Tensor               # [N, B] int32 in-shard descent batch
    noise: Optional[torch.Tensor]         # [P] AWGN, sorted-leaf order (None: σ = 0)
    asc_gumbel: torch.Tensor              # [N] ascent-set Gumbel
    asc_batch_idx: torch.Tensor           # [N, B] int32 in-shard ascent batch
    # [N, P] f32 U[0, 1) stochastic-rounding uniforms, row i for client i
    # (transport="quantized" only; None otherwise)
    quant_uniform: Optional[torch.Tensor] = None
    # temporal runs only (None otherwise): the shadow walk's innovation
    # normals, the reference's normal(fold_in(k_chan, 2), (N,)), and the
    # availability chain's uniforms, uniform(fold_in(k_chan, 3), (N,)); the
    # fading innovation reuses chan_normal and the i.i.d. shadow
    # shadow_normal, as the reference reuses k_chan and its stream 1
    walk_normal: Optional[torch.Tensor] = None      # [N]
    avail_uniform: Optional[torch.Tensor] = None    # [N] U[0, 1)

    def to(self, device) -> "RoundDraws":
        return RoundDraws(*(None if v is None else v.to(device) for v in self))


class InitDraws(NamedTuple):
    """The random inputs of a run's initial state: for a temporal run the
    fading state's normals [2, N, draw_sc], the reference's
    ``normal(fold_in(k_init, 1), (2, N, draw_sc))`` (None for a static
    run). A batched run's lead with [G] (:func:`stack_init_draws`)."""

    fast_normal: Optional[torch.Tensor] = None

    def to(self, device) -> "InitDraws":
        return InitDraws(*(None if v is None else v.to(device) for v in self))


def gumbel(gen: torch.Generator, n: int) -> torch.Tensor:
    """[n] standard Gumbel draws, -log(-log U) with U in [tiny, 1) as in
    ``jax.random.gumbel``."""
    u = torch.rand((n,), generator=gen, device=gen.device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))


def batch_indices(gen: torch.Generator, n: int, shard_size: int,
                  batch_size: int) -> torch.Tensor:
    """[N, B] int32 in-shard sample indices, drawn for all N clients."""
    return torch.randint(0, shard_size, (n, batch_size), generator=gen,
                         device=gen.device, dtype=torch.int32)


def draw_round(gen: torch.Generator, quant_gen: torch.Generator, fl: FLConfig,
               model_size: int, shard_size: int, device=None,
               temporal_gen: Optional[torch.Generator] = None) -> RoundDraws:
    """One round's draws, moved to ``device``. ``shard_size`` is the number
    of training samples per client. The quantized transport's rounding
    uniforms come from ``quant_gen``, a temporal run's walk normals and
    availability uniforms from ``temporal_gen``, and everything else from
    ``gen`` (all on one device): as the reference's fold_in streams, the
    other two leave ``gen``'s draws as they are, so analog and quantized,
    static and temporal runs of one seed see the same channels, selections,
    batches and noise."""
    n, b = fl.num_clients, fl.batch_size
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    gd = gen.device
    if fl.temporal and temporal_gen is None:
        raise ValueError("a temporal run's draws need the temporal stream")

    def randint():
        return batch_indices(gen, n, shard_size, b)

    draws = RoundDraws(
        chan_normal=torch.randn((2, n, draw_sc), generator=gen, device=gd),
        shadow_normal=torch.randn((n, 1), generator=gen, device=gd),
        sel_gumbel=None if fl.method == "greedy" else gumbel(gen, n),
        batch_idx=randint(),
        noise=None if fl.noise_std == 0 else flat_awgn(gen, model_size),
        asc_gumbel=gumbel(gen, n),
        asc_batch_idx=randint(),
        quant_uniform=(torch.rand((n, model_size), generator=quant_gen, device=gd)
                       if fl.transport == "quantized" else None),
        walk_normal=(torch.randn((n,), generator=temporal_gen, device=gd)
                     if fl.temporal else None),
        avail_uniform=(torch.rand((n,), generator=temporal_gen, device=gd)
                       if fl.temporal else None),
    )
    return draws if device is None else draws.to(device)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _temporal_generator(seed: int, device) -> torch.Generator:
    """The third stream of a run seeded with ``seed``."""
    return _generator(seed * 1_000_003 + 11, device)


def draw_init(temporal_gen: torch.Generator, fl: FLConfig) -> InitDraws:
    """A run's initial draws from its temporal stream (none for a static
    run, which draws nothing from it)."""
    if not fl.temporal:
        return InitDraws()
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    return InitDraws(torch.randn((2, fl.num_clients, draw_sc),
                                 generator=temporal_gen,
                                 device=temporal_gen.device))


def init_draws(seed: int, fl: FLConfig, device) -> InitDraws:
    """The initial draws of a run seeded with ``seed``, made on ``device``:
    the first numbers of its temporal stream, which :func:`round_draws`
    skips."""
    return draw_init(_temporal_generator(seed, device), fl)


def seed_generators(seed: int, device):
    """The three streams of a run seeded with ``seed``, on ``device``:
    ``(gen, quant_gen, temporal_gen)``, as :func:`draw_round` takes them."""
    return (_generator(seed, device), _generator(seed * 1_000_003 + 7, device),
            _temporal_generator(seed, device))


def round_draws(seed: int, fl: FLConfig, model_size: int, shard_size: int,
                device) -> Iterator[RoundDraws]:
    """The ``fl.rounds`` rounds' draws of a run seeded with ``seed``, made on
    ``device``."""
    gen, quant_gen, temporal_gen = seed_generators(seed, device)
    draw_init(temporal_gen, fl)   # the initial state's; see init_draws
    for _ in range(fl.rounds):
        yield draw_round(gen, quant_gen, fl, model_size, shard_size,
                         temporal_gen=temporal_gen)


def draw_signature(fl: FLConfig) -> tuple:
    """What :func:`draw_round` and :func:`draw_init` read of a config: two
    configs with the same signature draw the same numbers from the same
    seed."""
    return (fl.rounds, fl.num_clients, fl.batch_size, fl.flat_fading,
            fl.num_subcarriers, fl.method == "greedy", fl.noise_std == 0,
            fl.transport == "quantized", fl.temporal)


def stack_draws(cells: Sequence[RoundDraws], noise: bool,
                model_size: int) -> RoundDraws:
    """One round's draws of G cells as one ``RoundDraws`` with a leading [G]
    on every field (views for G = 1). ``noise``: whether the round reads
    AWGN (False: a statically noise-free group, and ``noise`` is None); a
    cell that drew none (σ = 0) then reads a zero row."""
    first = cells[0]
    dev = first.chan_normal.device

    def stack(vals):
        return vals[0].unsqueeze(0) if len(vals) == 1 else torch.stack(vals)

    def field(name):
        vals = [getattr(d, name) for d in cells]
        return None if vals[0] is None else stack(vals)

    z = None
    if noise:
        zero = torch.zeros((model_size,), dtype=torch.float32, device=dev)
        z = stack([zero if d.noise is None else d.noise for d in cells])
    return RoundDraws(
        chan_normal=field("chan_normal"), shadow_normal=field("shadow_normal"),
        sel_gumbel=field("sel_gumbel"), batch_idx=field("batch_idx"),
        noise=z, asc_gumbel=field("asc_gumbel"),
        asc_batch_idx=field("asc_batch_idx"),
        quant_uniform=field("quant_uniform"),
        walk_normal=field("walk_normal"), avail_uniform=field("avail_uniform"))


def stack_init_draws(cells: Sequence[InitDraws]) -> InitDraws:
    """G cells' initial draws as one ``InitDraws`` with a leading [G]."""
    vals = [d.fast_normal for d in cells]
    return InitDraws(None if vals[0] is None else torch.stack(vals))


# ---------------------------------------------------------------------------
# Id-addressed draws (the sharded control plane)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mix32(x: int) -> int:
    """A 32-bit integer hash (Wellons' lowbias32) of a Python int."""
    x &= _MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _MASK32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x·c) mod 2³² for int64 ``x`` in [0, 2³²): c in two 16-bit limbs, so
    no product exceeds 2⁴⁸ and nothing relies on int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix32` elementwise over an int64 tensor of 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class Stream:
    """An id-addressed random stream, as a JAX key is under the sharded
    control plane: every method answers ``[n, *shape]`` values for the
    global client ids ``ids`` [n], row c a function of (stream, ids[c])
    alone. Subclasses give :meth:`fold` and the four draws."""

    def fold(self, i: int) -> "Stream":
        raise NotImplementedError

    def normal(self, ids: torch.Tensor, shape=()) -> torch.Tensor:
        raise NotImplementedError

    def uniform(self, ids: torch.Tensor, shape=()) -> torch.Tensor:
        raise NotImplementedError

    def gumbel(self, ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def randint(self, ids: torch.Tensor, shape, high: int) -> torch.Tensor:
        raise NotImplementedError


class HashStream(Stream):
    """A stream of :class:`HashDraws`: ``key`` is the 32-bit hash of its
    path (seed, round, role, folds). Element e of client i's row is
    mix(mix(key ^ i) ^ mix(e·φ + 1)) with φ the golden-ratio constant, a
    32-bit integer computed in int64 on the ids' device; the floats come
    from its top bits.

    A tuple of keys is G streams at once, one a cell: a draw at ids [n]
    (the same clients in every cell) or [G, n] (each cell its own) answers
    [G, n, ...], row g what the stream of key g alone gives."""

    def __init__(self, key):
        self.key = key
        self._keys = {}   # a tuple's keys as a [G, 1] tensor, by device

    def fold(self, i: int) -> "HashStream":
        f = _mix32(0x3C6EF372 + int(i))
        if isinstance(self.key, tuple):
            return HashStream(tuple(_mix32(k ^ f) for k in self.key))
        return HashStream(_mix32(self.key ^ f))

    def bits(self, ids: torch.Tensor, width: int) -> torch.Tensor:
        """[..., n, width] int64 values in [0, 2³²)."""
        key = self.key
        if isinstance(key, tuple):
            if ids.device not in self._keys:
                self._keys[ids.device] = torch.tensor(
                    key, dtype=torch.int64).to(ids.device)[:, None]
            key = self._keys[ids.device]
        row = _mix((ids.to(torch.int64) & _MASK32) ^ key)
        e = torch.arange(width, dtype=torch.int64, device=ids.device)
        col = _mix((_mul32(e, 0x9E3779B9) + 1) & _MASK32)
        return _mix(row[..., None] ^ col)

    def _draw(self, ids, shape):
        width = math.prod(shape)
        b = self.bits(ids, width)
        return b, (*b.shape[:-1], *shape)

    def uniform(self, ids, shape=()):
        """U[0, 1) on the 2⁻²⁴ grid (exact in f32)."""
        b, out = self._draw(ids, shape)
        return ((b >> 8).to(torch.float32) * 2.0 ** -24).reshape(out)

    def normal(self, ids, shape=()):
        """√2·erfinv(v), v = (2m + 1 − 2²³)·2⁻²³ for the top 23 bits m:
        an exact f32 in (−1, 1), so no draw is infinite (|x| < 5.3)."""
        b, out = self._draw(ids, shape)
        v = ((b >> 9) * 2 + 1 - (1 << 23)).to(torch.float32) * 2.0 ** -23
        return (torch.erfinv(v) * math.sqrt(2.0)).reshape(out)

    def gumbel(self, ids):
        """−log(−log U), U in [tiny, 1), as ``draws.gumbel``."""
        u = self.uniform(ids)
        return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(u.dtype).tiny)))

    def randint(self, ids, shape, high: int):
        """int32 in [0, high): the top of the 32-bit value times ``high``
        (exact: the product stays below 2⁶³)."""
        if not 0 < high < 2 ** 31:
            raise ValueError(f"randint needs 0 < high < 2**31, got {high}")
        b, out = self._draw(ids, shape)
        return ((b * high) >> 32).to(torch.int32).reshape(out)


class CellStream(Stream):
    """G streams of any kind as one: a draw at ids [n] (the same clients in
    every cell) or [G, n] (each cell its own) stacks the cells' draws into
    [G, n, ...]."""

    def __init__(self, streams: Sequence[Stream]):
        self.streams = list(streams)

    def fold(self, i: int) -> "CellStream":
        return CellStream([s.fold(i) for s in self.streams])

    def _each(self, name, ids, *args):
        return torch.stack([getattr(s, name)(ids if ids.dim() == 1 else ids[g],
                                             *args)
                            for g, s in enumerate(self.streams)])

    def normal(self, ids, shape=()):
        return self._each("normal", ids, shape)

    def uniform(self, ids, shape=()):
        return self._each("uniform", ids, shape)

    def gumbel(self, ids):
        return self._each("gumbel", ids)

    def randint(self, ids, shape, high: int):
        return self._each("randint", ids, shape, high)


def cell_stream(streams: Sequence[Stream]) -> Stream:
    """One stream over the cells' ``streams``: a :class:`HashStream` of
    their keys when all are hash streams (one draw for the whole group),
    else a :class:`CellStream`."""
    if all(isinstance(s, HashStream) and isinstance(s.key, int) for s in streams):
        return HashStream(tuple(s.key for s in streams))
    return CellStream(streams)


class RoundStreams(NamedTuple):
    """One round's streams, in the reference's split order
    ``(k_chan, k_sel, k_batch, k_noise, k_asel, k_abatch)``, and its
    receiver noise: ``awgn(model_size)`` is the [P] AWGN in sorted-leaf
    order, the same wherever it is asked."""

    chan: Stream     # fading normals; fold 1 shadow, 2 walk, 3 availability
    sel: Stream      # selection Gumbel
    batch: Stream    # descent batch indices
    noise: Stream    # fold 7: the quantized transport's rounding uniforms
    asel: Stream     # ascent-set Gumbel
    abatch: Stream   # ascent (and descent-loss) batch indices
    awgn: Callable   # model_size -> [P] standard normals


class IdDraws:
    """A run's id-addressed random source: :meth:`round` gives round t's
    streams, :meth:`init` the stream of the initial state (a temporal run's
    fading normals)."""

    def round(self, t: int) -> RoundStreams:
        raise NotImplementedError

    def init(self) -> Stream:
        raise NotImplementedError


class HashDraws(IdDraws):
    """The port's own id-addressed source: a counter-based hash of (seed,
    round, stream, id, element) on ``device`` (``None``: the card). The
    same seed gives the same integers on every device and for any split of
    the ids."""

    ROLES = ("chan", "sel", "batch", "noise", "asel", "abatch")

    def __init__(self, seed: int, device=None):
        self.seed, self.device = int(seed), resolve_device(device)
        self._base = _mix32(_mix32(self.seed & _MASK32) ^ _mix32(self.seed >> 32))

    def _stream(self, *path: int) -> HashStream:
        key = self._base
        for p in path:
            key = _mix32(key ^ _mix32(int(p) + 0x9E3779B9))
        return HashStream(key)

    def awgn_stream(self, t: int) -> HashStream:
        """Round t's receiver-noise stream, read at id 0."""
        return self._stream(t + 1, len(self.ROLES))

    def round(self, t: int) -> RoundStreams:
        streams = [self._stream(t + 1, r) for r in range(len(self.ROLES))]
        return RoundStreams(*streams, awgn=_hash_awgn(self.awgn_stream(t),
                                                      self.device))

    def init(self) -> Stream:
        return self._stream(0)


def _hash_awgn(noise: HashStream, device) -> Callable:
    """``model_size -> [P]`` (or [G, P] for a tuple of keys) standard
    normals of a receiver-noise stream, read at id 0."""
    def awgn(model_size: int) -> torch.Tensor:
        one = torch.zeros((1,), dtype=torch.int64, device=device)
        return noise.normal(one, (model_size,))[..., 0, :]

    return awgn


class CellDraws(IdDraws):
    """A sweep group's G id-addressed sources as one (``cells`` = G): each
    round's streams answer [G, ...] draws (:func:`cell_stream`), its AWGN
    is [G, P], and :meth:`init` the cells' initial streams. Cell g's values
    are those of ``sources[g]`` alone, so a cell of a group draws what its
    own run draws. Hash sources on one device draw the whole group at
    once."""

    def __init__(self, sources: Sequence[IdDraws]):
        self.sources = list(sources)
        self.cells = len(self.sources)
        self._hash = all(isinstance(s, HashDraws) for s in self.sources) and \
            len({str(s.device) for s in self.sources}) == 1

    def round(self, t: int) -> RoundStreams:
        rounds = [s.round(t) for s in self.sources]
        streams = [cell_stream([r[i] for r in rounds])
                   for i in range(len(HashDraws.ROLES))]
        if self._hash:
            awgn = _hash_awgn(cell_stream([s.awgn_stream(t) for s in self.sources]),
                              self.sources[0].device)
        else:
            def awgn(model_size: int) -> torch.Tensor:
                return torch.stack([r.awgn(model_size) for r in rounds])
        return RoundStreams(*streams, awgn=awgn)

    def init(self) -> Stream:
        return cell_stream([s.init() for s in self.sources])


def client_rows(draws: RoundStreams, fl: FLConfig, ids: torch.Tensor,
                model_size: int, shard_size: int) -> RoundDraws:
    """A round's draws at the clients ``ids`` as a :class:`RoundDraws` whose
    rows are those clients (all N of them at ``ids = arange(N)``), for code
    that takes a whole round's table: the parameter server under the
    sharded control plane. Roles as the sharded simulator round reads them;
    the AWGN is the round's [P] draw."""
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    b = fl.batch_size
    chan = draws.chan
    return RoundDraws(
        chan_normal=chan.normal(ids, (2, draw_sc)).movedim(0, 1),
        shadow_normal=chan.fold(1).normal(ids)[:, None],
        sel_gumbel=None if fl.method == "greedy" else draws.sel.gumbel(ids),
        batch_idx=draws.batch.randint(ids, (b,), shard_size),
        noise=None if fl.noise_std == 0 else draws.awgn(model_size),
        asc_gumbel=draws.asel.gumbel(ids),
        asc_batch_idx=draws.abatch.randint(ids, (b,), shard_size),
        quant_uniform=(draws.noise.fold(7).uniform(ids, (model_size,))
                       if fl.transport == "quantized" else None),
        walk_normal=chan.fold(2).normal(ids) if fl.temporal else None,
        avail_uniform=chan.fold(3).uniform(ids) if fl.temporal else None,
    )


def client_init_rows(source: IdDraws, fl: FLConfig,
                     ids: torch.Tensor) -> InitDraws:
    """The initial draws at the clients ``ids``: a temporal run's fading
    normals [2, n, draw_sc] from ``source.init()`` (none for a static run)."""
    if not fl.temporal:
        return InitDraws()
    draw_sc = 1 if fl.flat_fading else fl.num_subcarriers
    return InitDraws(source.init().normal(ids, (2, draw_sc)).movedim(0, 1))
