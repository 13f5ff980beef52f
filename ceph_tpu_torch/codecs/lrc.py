"""Locally Repairable Codes via layered nested codes — the lrc plugin.

Behavioral mirror of src/erasure-code/lrc/ErasureCodeLrc.{h,cc}: a
profile either gives ``k``/``m``/``l`` (the "kml" form, expanded to a
generated mapping + layer list, ErasureCodeLrc.cc:291-360) or an
explicit ``mapping`` string plus a ``layers`` JSON array
``[["<chunks_map>", {<profile>}], ...]`` (ErasureCodeLrc.cc:139-248).

Each layer is an inner MDS codec (default jerasure reed_sol_van)
applied to the subset of global chunk *positions* its map selects:
``D`` = layer data, ``c`` = layer coding, ``_`` = not in this layer.
Inner codecs live on the LRC codec's own device. Local layers rebuild a
single lost chunk from its small group instead of k survivors — the
locality ``minimum_to_decode`` exposes (ErasureCodeLrc.cc
_minimum_to_decode).

A full-stripe encode composes the whole layer cascade into ONE [m, k]
generator (GF-linear through every layer), so it is a single matrix
apply whatever the layer count; decode keeps the layered walk.

``local_parity=xor`` (kml form) generates the local layers on the
``xor`` plugin: their repair and parity-delta rows are then 0/1, and on
the card the inner dispatch rides the XOR-schedule kernel
(``matrix_codec._try_sched_bytes``, w=1). The default ``rs`` keeps the
corpus-pinned reed_sol_van layout.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ceph_tpu_torch import PLUGIN_ABI_VERSION

from .base import ErasureCodeBase, to_int
from .interface import Buffer, ErasureCodeProfile, Flag, SubChunkPlan
from .matrix_codec import BitplaneDispatchMixin, dispatch_counters
from .registry import registry


class Layer:
    """One nested code layer over a subset of global positions."""

    def __init__(self, chunks_map: str, profile: ErasureCodeProfile) -> None:
        self.chunks_map = chunks_map
        self.profile = dict(profile)
        # Global positions, in inner-codec order: data first, coding after
        # (layers_init, ErasureCodeLrc.cc:209-248).
        self.data = [i for i, c in enumerate(chunks_map) if c == "D"]
        self.coding = [i for i, c in enumerate(chunks_map) if c == "c"]
        self.chunks = self.data + self.coding
        self.chunk_set = set(self.chunks)
        self.codec = None  # set by init_codec

    def init_codec(self, device: torch.device) -> None:
        """Build the inner codec on ``device`` (the LRC codec's)."""
        prof = dict(self.profile)
        prof.setdefault("k", str(len(self.data)))
        prof.setdefault("m", str(len(self.coding)))
        prof.setdefault("plugin", "jerasure")
        if prof["plugin"] == "jerasure":
            prof.setdefault("technique", "reed_sol_van")
        plugin = prof.pop("plugin")
        self.codec = registry.factory(plugin, prof, device=device)


class LrcCodec(BitplaneDispatchMixin, ErasureCodeBase):
    """The lrc plugin. Shard ids at the API are logical (0..k-1 data,
    k.. parity); the mapping string defines stored positions, exposed
    via get_chunk_mapping."""

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = dict(profile)
        prof = dict(profile)
        self._parse_kml(prof)
        if "mapping" not in prof:
            raise ValueError(f"the 'mapping' profile is missing from {prof}")
        mapping = prof["mapping"]
        if "layers" not in prof:
            raise ValueError(f"the 'layers' profile is missing from {prof}")
        self.layers = self._layers_parse(prof["layers"])
        for layer in self.layers:
            layer.init_codec(self._target_device())
        self.mapping = mapping
        self.k = mapping.count("D")
        self.m = len(mapping) - self.k
        self._sanity_checks(prof["layers"])
        # logical -> position: data ids take the 'D' positions in order,
        # parity ids the rest
        d_pos = [i for i, c in enumerate(mapping) if c == "D"]
        p_pos = [i for i, c in enumerate(mapping) if c != "D"]
        self.chunk_mapping = d_pos + p_pos
        self._pos_to_logical = {p: i for i, p in enumerate(self.chunk_mapping)}
        # the layer cascade as ONE [m, k] generator: local parities over
        # globally generated chunks substitute the global rows
        # (L @ [D; G@D] = (L1 ^ L2*G) @ D), byte-identical to the walk
        self._composite = self._compose_generator()
        if self._composite is not None:
            from ceph_tpu_torch.gf import gf_matrix_to_bitmatrix

            self._comp_bmat_np = gf_matrix_to_bitmatrix(self._composite)

    def _compose_generator(self):
        """[m, k] composite parity generator over the data chunks, or
        None when a layer's inner codec exposes no byte generator."""
        from ceph_tpu_torch.gf.matrices import gf_matmul_np

        rows: dict[int, np.ndarray] = {}
        for i in range(self.k):
            r = np.zeros(self.k, np.uint8)
            r[i] = 1
            rows[self.chunk_mapping[i]] = r
        for layer in self.layers:
            gen = getattr(layer.codec, "generator", None)
            if gen is None:
                return None
            kl = len(layer.data)
            inmat = np.stack([
                rows.get(p, np.zeros(self.k, np.uint8))
                for p in layer.data
            ])
            coding = gf_matmul_np(np.asarray(gen)[kl:, :], inmat)
            for j, p in enumerate(layer.coding):
                rows[p] = coding[j]
        parity_pos = self.chunk_mapping[self.k :]
        if any(p not in rows for p in parity_pos):
            return None
        return np.stack([rows[p] for p in parity_pos])

    # -- profile parsing ----------------------------------------------
    def _parse_kml(self, prof: ErasureCodeProfile) -> None:
        """Expand k/m/l into mapping + layers (parse_kml,
        ErasureCodeLrc.cc:291-360). ``local_parity`` picks the generated
        local layers' code: ``rs`` (default; reed_sol_van) or ``xor``
        (the xor plugin). Global layers are always RS."""
        local_parity = prof.pop("local_parity", "rs")
        if local_parity not in ("rs", "xor"):
            raise ValueError(
                f"local_parity={local_parity!r} must be 'rs' or 'xor'"
            )
        k = to_int("k", prof, -1)
        m = to_int("m", prof, -1)
        l = to_int("l", prof, -1)  # noqa: E741 — the reference's name
        if k == -1 and m == -1 and l == -1:
            if local_parity != "rs":
                raise ValueError(
                    "local_parity applies to the k/m/l form only "
                    "(explicit layers name their own plugin)"
                )
            return
        if -1 in (k, m, l):
            raise ValueError("All of k, m, l must be set or none of them")
        for key in ("mapping", "layers"):
            if key in prof:
                raise ValueError(
                    f"The {key} parameter cannot be set when k, m, l are set"
                )
        if l == 0 or (k + m) % l:
            raise ValueError(f"k + m must be a multiple of l (k={k} m={m} l={l})")
        groups = (k + m) // l
        if k % groups:
            raise ValueError("k must be a multiple of (k + m) / l")
        if m % groups:
            raise ValueError("m must be a multiple of (k + m) / l")
        kg, mg = k // groups, m // groups
        prof["mapping"] = ("D" * kg + "_" * mg + "_") * groups
        # the global layer covers every group's data + coding positions
        layer_list = [[("D" * kg + "c" * mg + "_") * groups, ""]]
        # one local layer per group: group data + group coding as local
        # data, the trailing slot as the local parity
        local_prof = "plugin=xor" if local_parity == "xor" else ""
        for g in range(groups):
            row = (
                "_" * (g * (kg + mg + 1))
                + "D" * (kg + mg)
                + "c"
                + "_" * ((groups - g - 1) * (kg + mg + 1))
            )
            layer_list.append([row, local_prof])
        prof["layers"] = json.dumps(layer_list)

    def _layers_parse(self, description: str) -> list[Layer]:
        try:
            arr = json.loads(description)
        except json.JSONDecodeError as e:
            raise ValueError(f"layers is not valid JSON: {e}") from e
        if not isinstance(arr, list):
            raise ValueError(f"layers must be a JSON array, got {arr!r}")
        layers = []
        for pos, entry in enumerate(arr):
            if not isinstance(entry, list):
                raise ValueError(
                    f"each element of layers must be a JSON array but "
                    f"position {pos} is {entry!r}"
                )
            if not entry or not isinstance(entry[0], str):
                raise ValueError(
                    f"the first element of entry {pos} must be a string"
                )
            layer_prof: ErasureCodeProfile = {}
            if len(entry) > 1:
                second = entry[1]
                if isinstance(second, dict):
                    layer_prof = {k: str(v) for k, v in second.items()}
                elif isinstance(second, str):
                    for kv in second.split():
                        if "=" not in kv:
                            raise ValueError(
                                f"expected key=value in layer profile, got {kv!r}"
                            )
                        key, val = kv.split("=", 1)
                        layer_prof[key] = val
                else:
                    raise ValueError(
                        f"the second element of entry {pos} must be a "
                        f"string or object, got {second!r}"
                    )
            layers.append(Layer(entry[0], layer_prof))
        return layers

    def _sanity_checks(self, description: str) -> None:
        if len(self.layers) < 1:
            raise ValueError(
                f"layers parameter has {len(self.layers)} which is less "
                f"than the minimum of one: {description}"
            )
        n = len(self.mapping)
        for i, layer in enumerate(self.layers):
            if len(layer.chunks_map) != n:
                raise ValueError(
                    f"the mapping of layer {i} ({layer.chunks_map!r}) is "
                    f"expected to be {n} characters long but is "
                    f"{len(layer.chunks_map)} characters long instead"
                )
        # producibility: walking layers in encode order, every layer
        # data position must already be known (global 'D' or an earlier
        # layer's 'c'), and every non-'D' position must be produced
        known = {i for i, ch in enumerate(self.mapping) if ch == "D"}
        for i, layer in enumerate(self.layers):
            missing = [p for p in layer.data if p not in known]
            if missing:
                raise ValueError(
                    f"layer {i} ({layer.chunks_map!r}) reads positions "
                    f"{missing} that no earlier layer produces"
                )
            known |= set(layer.coding)
        unproduced = [
            p for p, ch in enumerate(self.mapping)
            if ch != "D" and p not in known
        ]
        if unproduced:
            raise ValueError(
                f"mapping positions {unproduced} are coding chunks but "
                f"no layer produces them"
            )

    # -- geometry ------------------------------------------------------
    def get_flags(self) -> Flag:
        return (
            Flag.PARTIAL_READ_OPTIMIZATION
            | Flag.PARTIAL_WRITE_OPTIMIZATION
            | Flag.ZERO_INPUT_ZERO_OUTPUT
        )

    # -- position/logical translation ---------------------------------
    def _to_positions(self, logical: set[int]) -> set[int]:
        return {self.chunk_mapping[s] for s in logical}

    def _to_logical(self, positions: set[int]) -> set[int]:
        return {self._pos_to_logical[p] for p in positions}

    # -- encode --------------------------------------------------------
    def encode_chunks(self, data: dict[int, Buffer]) -> dict[int, Buffer]:
        if self._composite is not None:
            return self._encode_composite(data)
        return self._encode_layered(data)

    def _encode_composite(self, data: dict[int, Buffer]) -> dict[int, Buffer]:
        """All layers as one matrix apply (see init)."""
        shards = self._shard_list(data)
        if self._shards_host_route(shards):
            from ceph_tpu_torch.gf import gf_apply_bytes_host

            dispatch_counters().inc("host_encode")
            out = gf_apply_bytes_host(
                self._composite, np.stack(shards, axis=-2)
            )
            return {self.k + j: out[..., j, :] for j in range(self.m)}
        outs = self._dispatch_bitmatrix_shards(
            self._comp_bmat_np, shards, "encode"
        )
        return {self.k + j: outs[j] for j in range(self.m)}

    def _encode_layered(self, data: dict[int, Buffer]) -> dict[int, Buffer]:
        shards = self._shard_list(data)  # absent data shards are zero
        pool: dict[int, Buffer] = {
            self.chunk_mapping[i]: shards[i] for i in range(self.k)
        }
        # layers in order: the global layer first, then locals (which
        # may consume globally generated coding chunks as their data)
        for layer in self.layers:
            kl = len(layer.data)
            layer_in = {j: pool[p] for j, p in enumerate(layer.data) if p in pool}
            parity = layer.codec.encode_chunks(layer_in)
            for j, p in enumerate(layer.coding):
                pool[p] = parity[kl + j]
        return {
            self.k + j: pool[p]
            for j, p in enumerate(self.chunk_mapping[self.k :])
        }

    # -- decode --------------------------------------------------------
    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        pool: dict[int, Buffer] = {
            self.chunk_mapping[s]: arr for s, arr in chunks.items()
        }
        want_pos = self._to_positions(set(want_to_read))
        n = len(self.mapping)
        # reverse passes until converged (the decode_chunks reverse-layer
        # walk, ErasureCodeLrc.cc): local layers rebuild their group
        # cheaply; the global layer mops up
        progress = True
        while progress and not want_pos <= set(pool):
            progress = False
            for layer in reversed(self.layers):
                erased = [p for p in layer.chunks if p not in pool]
                if not erased:
                    continue
                if len(erased) > layer.codec.get_coding_chunk_count():
                    continue
                inner_id = {p: j for j, p in enumerate(layer.chunks)}
                inner_chunks = {
                    inner_id[p]: pool[p] for p in layer.chunk_set
                    if p in pool
                }
                inner_want = {inner_id[p] for p in erased}
                try:
                    out = layer.codec.decode_chunks(inner_want, inner_chunks)
                except ValueError:
                    continue
                for p in erased:
                    pool[p] = out[inner_id[p]]
                progress = True
        missing = want_pos - set(pool)
        if missing:
            raise ValueError(
                f"unable to read positions {sorted(missing)} from "
                f"{sorted(self._to_logical(set(pool) & set(range(n))))}"
            )
        return {s: pool[self.chunk_mapping[s]] for s in want_to_read}

    # -- planning ------------------------------------------------------
    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> SubChunkPlan:
        """The 3-case locality-aware minimum (ErasureCodeLrc.cc
        _minimum_to_decode): no-erasure fast path; cheapest recovering
        layers bottom-up; then all-available if a multi-layer cascade
        can still recover everything."""
        want_pos = self._to_positions(set(want_to_read))
        avail_pos = self._to_positions(set(available))
        n = len(self.mapping)
        erasures_total = {p for p in range(n) if p not in avail_pos}
        erasures_want = want_pos & erasures_total

        if not erasures_want:
            return {s: [(0, 1)] for s in want_to_read}

        minimum: set[int] = set()
        erasures_not_recovered = set(erasures_total)
        for layer in reversed(self.layers):
            layer_want = want_pos & layer.chunk_set
            if not layer_want:
                continue
            if not layer_want & erasures_want:
                minimum |= layer_want
                continue
            erased = layer.chunk_set & erasures_not_recovered
            if len(erased) > layer.codec.get_coding_chunk_count():
                continue
            minimum |= layer.chunk_set - erasures_not_recovered
            erasures_not_recovered -= erased
            erasures_want -= erased
        if not erasures_want:
            minimum |= want_pos
            minimum -= erasures_total
            return {s: [(0, 1)] for s in self._to_logical(minimum)}

        # case 3: cascade over all layers, greedily marking recoverable
        remaining = set(erasures_total)
        for layer in reversed(self.layers):
            layer_erasures = layer.chunk_set & remaining
            if not layer_erasures:
                continue
            if len(layer_erasures) <= layer.codec.get_coding_chunk_count():
                remaining -= layer_erasures
        if not remaining:
            return {s: [(0, 1)] for s in self._to_logical(avail_pos)}
        raise ValueError(
            f"not enough chunks in {sorted(available)} to read "
            f"{sorted(want_to_read)}"
        )


registry.register("lrc", LrcCodec, PLUGIN_ABI_VERSION)
