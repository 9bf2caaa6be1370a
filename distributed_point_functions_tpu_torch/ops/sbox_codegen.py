"""Generates `csrc/aes_generated.cuh`, the straight-line AES pieces of the
CUDA expansion kernels.

Nothing in the header is written by hand:

* the S-box is the tower-field circuit of `aes_sbox_tower.py`, traced
  symbolically into a gate list (XOR / AND / NOT on 32-bit words), with
  constants folded and common subexpressions shared;
* AddRoundKey is compiled in: for each fixed key (`keys.py`) and round,
  a set key bit flips its plane (`~`), a clear bit does nothing;
* the select-key AddRoundKey composes each plane's key bit from the
  left/right pair and a per-lane select word (the one-thread select-key
  AES whose instructions `chip_smoke.py` counts for K8's bound);
* ShiftRows+MixColumns follow `aes_bitslice._mix_columns_planes` plane
  for plane;
* the pieces of the split AES (`csrc/split_aes.cuh`, one 32-lane column
  shared by a group of 16 threads, a state byte each): `shift_rows_source`
  (the byte a ShiftRows position takes), `mix_byte` (one output byte of
  MixColumns from the shifted byte and two exchanged pair sums) and the
  round-key bytes `kRoundKeyBytes` the groups expand into plane masks.

Regenerate (and commit) after touching any of those:

    python -m distributed_point_functions_tpu_torch.ops.sbox_codegen

The CPU tests evaluate the traced circuit against the S-box table and
check that the committed header equals `render_header()`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import keys as fixed_keys
from . import aes as _aes
from . import aes_sbox_tower as _tower
from .aes_bitslice import _XTIME_TAPS, _rk_bits

HEADER_PATH = Path(__file__).resolve().parent.parent / "csrc" / "aes_generated.cuh"

# Key ids of `add_round_key(s, key, rnd)`, in this order.
ROUND_KEYS = (
    ("kKeyLeft", fixed_keys.RK_LEFT),
    ("kKeyRight", fixed_keys.RK_RIGHT),
    ("kKeyValue", fixed_keys.RK_VALUE),
)

ZERO, ONE = "0", "1"


class _Node:
    """A word of the traced circuit; `^` and `&` record gates."""

    __slots__ = ("net", "name")

    def __init__(self, net: "_Net", name: str):
        self.net = net
        self.name = name

    def __xor__(self, other):
        return self.net.gate("^", self, other)

    def __and__(self, other):
        return self.net.gate("&", self, other)


class _Net:
    """Gate list in definition order: name -> (op, operands)."""

    def __init__(self):
        self.defs: dict = {}
        self._memo: dict = {}

    def node(self, name: str) -> _Node:
        return _Node(self, name)

    def _emit(self, op: str, *args: str) -> _Node:
        key = (op,) + args
        name = self._memo.get(key)
        if name is None:
            name = f"t{len(self.defs)}"
            self.defs[name] = key
            self._memo[key] = name
        return self.node(name)

    def negate(self, a: str) -> _Node:
        if a == ZERO:
            return self.node(ONE)
        if a == ONE:
            return self.node(ZERO)
        d = self.defs.get(a)
        if d is not None and d[0] == "~":
            return self.node(d[1])
        return self._emit("~", a)

    def gate(self, op: str, x: _Node, y: _Node) -> _Node:
        a, b = sorted((x.name, y.name))
        if op == "^":
            if a == b:
                return self.node(ZERO)
            for u, v in ((a, b), (b, a)):
                if u == ZERO:
                    return self.node(v)
                if u == ONE:
                    return self.negate(v)
            return self._emit("^", a, b)
        if op == "&":
            if a == b:
                return self.node(a)
            for u, v in ((a, b), (b, a)):
                if u == ZERO:
                    return self.node(ZERO)
                if u == ONE:
                    return self.node(v)
            return self._emit("&", a, b)
        raise ValueError(op)

    def live(self, outputs) -> list:
        """Gate names reachable from `outputs`, in definition order."""
        seen = set()
        stack = list(outputs)
        while stack:
            n = stack.pop()
            if n in seen or n not in self.defs:
                continue
            seen.add(n)
            stack.extend(self.defs[n][1:])
        return [n for n in self.defs if n in seen]


def sbox_circuit():
    """(net, outputs): the tower S-box traced over inputs x0..x7 (bit i
    of the byte); outputs[i] is the name of output bit i."""
    net = _Net()
    xs = [net.node(f"x{i}") for i in range(8)]
    out = _tower.sbox_planes_tower(xs, net.node(ONE))
    return net, [o.name for o in out]


def evaluate_circuit(net: _Net, outputs, inputs):
    """Evaluate the traced circuit on numpy uint32 words (tests)."""
    env = {ZERO: np.uint32(0), ONE: np.uint32(0xFFFFFFFF)}
    for i, x in enumerate(inputs):
        env[f"x{i}"] = np.asarray(x, dtype=np.uint32)
    for name in net.live(outputs):
        op, *args = net.defs[name]
        if op == "~":
            env[name] = ~env[args[0]]
        elif op == "^":
            env[name] = env[args[0]] ^ env[args[1]]
        else:
            env[name] = env[args[0]] & env[args[1]]
    return [env[o] for o in outputs]


def _expr(name: str) -> str:
    return {ZERO: "0u", ONE: "0xffffffffu"}.get(name, name)


def _render_sbox(net: _Net, outputs) -> list:
    live = net.live(outputs)
    counts = {op: 0 for op in "^&~"}
    for name in live:
        counts[net.defs[name][0]] += 1
    params = ", ".join(f"uint32_t& b{i}" for i in range(8))
    lines = [
        "// Tower-field S-box on the 8 bit planes of one state byte, in place",
        f"// ({counts['^']} XOR, {counts['&']} AND, {counts['~']} NOT).",
        f"__device__ __forceinline__ void sbox_tower({params}) {{",
    ]
    lines += [f"  const uint32_t x{i} = b{i};" for i in range(8)]
    for name in live:
        op, *args = net.defs[name]
        if op == "~":
            rhs = f"~{_expr(args[0])}"
        else:
            rhs = f"{_expr(args[0])} {op} {_expr(args[1])}"
        lines.append(f"  const uint32_t {name} = {rhs};")
    lines += [f"  b{i} = {_expr(o)};" for i, o in enumerate(outputs)]
    lines.append("}")
    return lines


def _render_sub_bytes() -> list:
    lines = [
        "// SubBytes: the S-box on each of the 16 state bytes.",
        "__device__ __forceinline__ void sub_bytes(uint32_t (&s)[128]) {",
    ]
    for j in range(16):
        args = ", ".join(f"s[{8 * j + i}]" for i in range(8))
        lines.append(f"  sbox_tower({args});")
    lines.append("}")
    return lines


def _render_shift_rows() -> list:
    sr = [int(v) for v in _aes._SHIFT_ROWS]
    lines = [
        "// ShiftRows alone (the last round): byte k takes byte SR[k].",
        "__device__ __forceinline__ void shift_rows(uint32_t (&s)[128]) {",
    ]
    moved = [k for k in range(16) if sr[k] != k]
    for k in moved:
        for i in range(8):
            lines.append(f"  const uint32_t r{8 * sr[k] + i} = s[{8 * sr[k] + i}];")
    for k in moved:
        for i in range(8):
            lines.append(f"  s[{8 * k + i}] = r{8 * sr[k] + i};")
    lines.append("}")
    return lines


def _render_shift_rows_mix_columns() -> list:
    """Byte 4c + r of the shifted state is byte SR[4c + r] of the input;
    each column then mixes as in `aes_bitslice._mix_columns_planes`."""
    sr = [int(v) for v in _aes._SHIFT_ROWS]
    lines = [
        "// ShiftRows then MixColumns (rounds 1-9): per column c,",
        "// o_r = a_r ^ t ^ xtime(a_r ^ a_{r+1}) with t = a_0 ^ a_1 ^ a_2 ^ a_3.",
        "__device__ __forceinline__ void shift_rows_mix_columns(uint32_t (&s)[128]) {",
    ]
    for p in range(128):
        lines.append(f"  const uint32_t r{p} = s[{p}];")
    for c in range(4):
        a = [[f"r{8 * sr[4 * c + r] + b}" for b in range(8)] for r in range(4)]
        lines.append("  {")
        for b in range(8):
            lines.append(
                f"    const uint32_t t{b} = "
                f"{a[0][b]} ^ {a[1][b]} ^ {a[2][b]} ^ {a[3][b]};"
            )
        for r in range(4):
            nxt = (r + 1) % 4
            for b in range(8):
                lines.append(
                    f"    const uint32_t u{r}_{b} = {a[r][b]} ^ {a[nxt][b]};"
                )
        for r in range(4):
            for b in range(8):
                xt = f"u{r}_7" if b == 0 else f"u{r}_{b - 1}"
                if b in _XTIME_TAPS:
                    xt = f"{xt} ^ u{r}_7"
                lines.append(
                    f"    s[{8 * (4 * c + r) + b}] = {a[r][b]} ^ t{b} ^ {xt};"
                )
        lines.append("  }")
    lines.append("}")
    return lines


def _render_round_keys() -> list:
    lines = [
        "// AddRoundKey with a fixed key: a set key bit flips its plane.",
    ]
    for k, (name, _) in enumerate(ROUND_KEYS):
        lines.append(f"constexpr int {name} = {k};")
    lines += [
        "__device__ __forceinline__ void add_round_key(uint32_t (&s)[128], "
        "int key, int rnd) {",
        "  switch (key * 11 + rnd) {",
    ]
    for k, (_, rk) in enumerate(ROUND_KEYS):
        bits = _rk_bits(rk)  # [11, 16, 8]
        for rnd in range(11):
            flips = " ".join(
                f"s[{8 * j + i}] = ~s[{8 * j + i}];"
                for j in range(16)
                for i in range(8)
                if bits[rnd, j, i]
            )
            lines.append(f"    case {11 * k + rnd}: {flips} break;")
    lines += ["    default: break;", "  }", "}"]
    return lines


def _render_round_keys_select() -> list:
    """Per-lane choice of the left or right key, branch-free: the key
    bit of a plane is `left & ~sel | right & sel`, so a plane where both
    keys set the bit flips, one where only the left (right) key sets it
    takes `~sel` (`sel`), and one where neither does is left alone (the
    composition of the JAX package's `aes_rounds_select_planes`)."""
    left = _rk_bits(fixed_keys.RK_LEFT)
    right = _rk_bits(fixed_keys.RK_RIGHT)
    lines = [
        "// AddRoundKey with a per-lane key: sel bit 0 takes kKeyLeft's bit,",
        "// sel bit 1 kKeyRight's (no branch on sel).",
        "__device__ __forceinline__ void add_round_key_select(uint32_t (&s)[128], "
        "uint32_t sel, int rnd) {",
        "  const uint32_t nsel = ~sel;",
        "  switch (rnd) {",
    ]
    for rnd in range(11):
        ops = []
        for j in range(16):
            for i in range(8):
                p = 8 * j + i
                b0, b1 = left[rnd, j, i], right[rnd, j, i]
                if b0 and b1:
                    ops.append(f"s[{p}] = ~s[{p}];")
                elif b0:
                    ops.append(f"s[{p}] ^= nsel;")
                elif b1:
                    ops.append(f"s[{p}] ^= sel;")
        lines.append(f"    case {rnd}: {' '.join(ops)} break;")
    lines += ["    default: break;", "  }", "}"]
    return lines


def _render_split_pieces() -> list:
    """The split AES's per-byte pieces. Byte 4c + r of the shifted state is
    input byte `shift_rows_source(4c + r)`; a 16-thread group's thread
    4c + r holds a = that byte, v = a ^ a_{r+1} and v2 = the v of row
    r + 2, so t = v ^ v2 and o_r = a ^ t ^ xtime(v)."""
    sr = [int(v) for v in _aes._SHIFT_ROWS]
    if any(sr[k] != (k & 3) + 4 * (((k >> 2) + (k & 3)) & 3) for k in range(16)):
        raise AssertionError("ShiftRows is not r + 4 * ((c + r) % 4)")
    lines = [
        "// ShiftRows: position k = 4c + r of the shifted state takes input byte",
        "// r + 4 * ((c + r) % 4).",
        "__device__ __forceinline__ int shift_rows_source(int k) {",
        "  return (k & 3) + 4 * (((k >> 2) + (k & 3)) & 3);",
        "}",
        "",
        "// One MixColumns output byte (8 planes) from its shifted byte a, the",
        "// pair sum v = a ^ a_{r+1} and the pair sum v2 = a_{r+2} ^ a_{r+3}.",
        "__device__ __forceinline__ void mix_byte(const uint32_t (&a)[8], "
        "const uint32_t (&v)[8], const uint32_t (&v2)[8], uint32_t (&o)[8]) {",
    ]
    for b in range(8):
        xt = "v[7]" if b == 0 else f"v[{b - 1}]"
        if b in _XTIME_TAPS:
            xt = f"{xt} ^ v[7]"
        lines.append(f"  o[{b}] = a[{b}] ^ v[{b}] ^ v2[{b}] ^ {xt};")
    lines.append("}")
    return lines


def _render_round_key_bytes() -> list:
    """The round keys of `ROUND_KEYS` as bytes [key][round][byte], which the
    split AES expands into plane masks in shared memory (its threads hold
    different bytes, so the key bits cannot be compiled in). Device
    memory, not constant memory: a warp reads several bytes at once, which
    constant memory would serialise."""
    lines = [
        "// Round-key bytes [key id][round][byte] of kKeyLeft, kKeyRight, kKeyValue.",
        "#ifdef __CUDACC__",
        "#define DPF_KEY_TABLE static __device__ const",
        "#else",
        "#define DPF_KEY_TABLE static const",
        "#endif",
        f"DPF_KEY_TABLE uint8_t kRoundKeyBytes[{len(ROUND_KEYS)}][11][16] = {{",
    ]
    for _, rk in ROUND_KEYS:
        rows = np.asarray(rk, dtype=np.uint8).reshape(11, 16)
        lines.append("  {")
        for row in rows:
            lines.append("    {" + ", ".join(str(int(x)) for x in row) + "},")
        lines.append("  },")
    lines.append("};")
    return lines


def render_header() -> str:
    net, outputs = sbox_circuit()
    parts = [
        [
            "// Generated by distributed_point_functions_tpu_torch/ops/"
            "sbox_codegen.py; do not edit.",
            "// Plane p = 8 * byte + bit of the AES state; one uint32_t word "
            "holds that bit for 32 lanes.",
            "#pragma once",
            "#include <cstdint>",
        ],
        _render_sbox(net, outputs),
        _render_sub_bytes(),
        _render_shift_rows(),
        _render_shift_rows_mix_columns(),
        _render_round_keys(),
        _render_round_keys_select(),
        _render_split_pieces(),
        _render_round_key_bytes(),
    ]
    return "\n\n".join("\n".join(p) for p in parts) + "\n"


def main() -> None:
    HEADER_PATH.write_text(render_header())
    print(f"wrote {HEADER_PATH}")


if __name__ == "__main__":
    main()
