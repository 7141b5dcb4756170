"""The inline-PTX wgmma wrappers of ``csrc/hopper.cuh``, read as text.

The bf16 flash forward issues ``wgmma.mma_async.m64nNk16`` through one
overload a width N: ``mma_ss`` (both operands through shared-memory
descriptors) for Q K^T at the kv tiles' N of 64 and 128, ``mma_rs`` (A from
registers, B transposed) for P V at every head dim padded to 16, 16..160.
The bf16 backward's wgmma kernels (``csrc/flash_attention_bwd.cu``) issue
``mma_ss`` for S^T, dP^T, S and dP at their 64-row walked tile and
``mma_rs`` for dV, dK and dQ at every padded head dim they dispatch to.
Each lists its N / 2 accumulator registers by number in the asm string and
again as operands; a slip in either compiles only on the card, and a wrong
number there reads or writes the wrong register. These tests hold every
overload to the pattern on the CPU, where no CUDA compiler runs.
"""

import os
import re

import pytest

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                    "repro_torch", "kernels", "csrc")
HEADER = os.path.join(CSRC, "hopper.cuh")
BWD = os.path.join(CSRC, "flash_attention_bwd.cu")


def _overloads(kind: str) -> dict:
    """{registers: body} of every ``mma_<kind>`` overload."""
    text = open(HEADER).read()
    found = {}
    for m in re.finditer(rf"void mma_{kind}\(float \(&d\)\[(\d+)\](.*?)\n}}",
                         text, re.S):
        found[int(m.group(1))] = m.group(2)
    return found


def _check_accumulators(body: str, regs: int) -> str:
    """The asm string's register list is %0..%regs-1 and the operands
    "+f"(d[0])..(d[regs-1]), in order; returns the asm string."""
    asm = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"\s*\n', body))
    listed = re.search(r"\.bf16 \{([^}]*)\}", asm).group(1)
    assert [int(x) for x in re.findall(r"%(\d+)", listed)] == list(
        range(regs))
    assert [int(x) for x in re.findall(r'"\+f"\(d\[(\d+)\]\)', body)] == \
        list(range(regs))
    assert f"m64n{2 * regs}k16" in asm
    return asm


@pytest.mark.parametrize("regs", [32, 64])
def test_mma_ss_overload(regs):
    """Q K^T at N = 64 and 128: descriptors a and b follow the
    accumulators, the scale-d predicate comes from the operand after them,
    both operands K-major (no transpose)."""
    body = _overloads("ss")[regs]
    asm = _check_accumulators(body, regs)
    assert f"setp.ne.b32 p, %{regs + 2}, 0;" in asm
    assert f"}}, %{regs}, %{regs + 1}, p, 1, 1, 0, 0;" in asm
    assert re.search(r':\s*"l"\(a\), "l"\(b\), "r"\(scale_d\)\);', body)


@pytest.mark.parametrize("regs", list(range(8, 81, 8)))
def test_mma_rs_overload(regs):
    """O += P V at N = 16..160: four A registers, then the B descriptor,
    the scale-d predicate from the operand after it, B transposed."""
    body = _overloads("rs")[regs]
    asm = _check_accumulators(body, regs)
    assert f"setp.ne.b32 p, %{regs + 5}, 0;" in asm
    a = ", ".join(f"%{regs + i}" for i in range(4))
    assert f"}}, {{{a}}}, %{regs + 4}, p, 1, 1, 1;" in asm
    assert re.search(r':\s*"r"\(a\[0\]\), "r"\(a\[1\]\), "r"\(a\[2\]\), '
                     r'"r"\(a\[3\]\), "l"\(b\), "r"\(scale_d\)\);', body)


def _bwd_widths() -> tuple:
    """(mma_ss registers, [mma_rs registers]) of the backward's wgmma
    kernels, read from their source: wg_scores' D (a 64 x kWgTile tile)
    and the padded head dims with_wg_hdp dispatches to (wg_accumulate's
    N)."""
    text = open(BWD).read()
    tile = int(re.search(r"constexpr int kWgTile = (\d+);", text).group(1))
    scores = int(re.search(r"void wg_scores\(float \(&d\)\[(\d+)\]",
                           text).group(1))
    assert scores == tile // 2
    assert re.search(r"void wg_accumulate\(float \(&acc\)\[kHdp / 2\]",
                     text)
    body = re.search(r"int with_wg_hdp\(int hd, Fn&& fn\) \{(.*?)\n\}",
                     text, re.S).group(1)
    hdps = [int(x) for x in
            re.findall(r"integral_constant<int, (\d+)>", body)]
    return scores, [hdp // 2 for hdp in hdps]


def test_every_width_the_kernel_takes_has_an_overload():
    """The forward's kv tiles (64 and 128 rows) and padded head dims (16
    to 160 in steps of 16) each have their overload, and no other exists;
    so do the backward's: its 64-row walked tile (mma_ss) and every padded
    head dim its wgmma kernels take, 32, 64, 112 and 128 (mma_rs)."""
    assert sorted(_overloads("ss")) == [32, 64]
    assert sorted(_overloads("rs")) == [hdp // 2 for hdp in range(16, 161, 16)]
    scores, accumulators = _bwd_widths()
    assert scores in _overloads("ss")
    assert accumulators == [hdp // 2 for hdp in (32, 64, 112, 128)]
    assert set(accumulators) <= set(_overloads("rs"))
