"""Build the grid kernels for the CPU: a threaded emulation of their CUDA
source, for rehearsing a ring and barrier protocol before the card.

Copies ``filodb_tpu_torch/csrc/`` into ``OUT`` (default
``filodb_tpu_torch/_build/emu``), rewrites each PTX helper (``smem_u32``,
the mbarrier and ``cp.async`` helpers, ``consumer_sync``) by name to an
emulated body from ``cuda_runtime.h`` beside this script, drops the
``cp.async.wait_all`` and ``fence.mbarrier_init`` lines, points dynamic
shared memory at one static buffer, turns each ``kernel<<<grid, block,
...>>>(args);`` into ``emu_launch`` (every CUDA thread a ``std::thread``,
CTAs one at a time), and compiles the sources with g++ into
``OUT/libemu.so``, which exposes the same C interface as the card's
library.

    python3 tools/emulate_kernels/build.py [OUT]
"""
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(REPO, "filodb_tpu_torch", "csrc")
SOURCES = ("grid_kernels.cu", "hist_staged.cu", "grouped_staged.cu",
           "dense_staged.cu", "series_staged.cu")

# each PTX helper's emulated body
EMU = {
    "smem_u32": "inline uint32_t smem_u32(const void*) { return 0; }",
    "mbar_init": "inline void mbar_init(uint64_t* bar, unsigned count) "
                 "{ emu_mbar_init(bar, count); }",
    "mbar_arrive": "inline void mbar_arrive(uint64_t* bar) "
                   "{ emu_mbar_arrive(bar); }",
    "mbar_wait": "inline void mbar_wait(uint64_t* bar, unsigned parity) "
                 "{ emu_mbar_wait(bar, parity); }",
    "cp_async16": "inline void cp_async16(void* dst, const void* src) "
                  "{ memcpy(dst, src, 16); }",
    "cp_async_arrive": "inline void cp_async_arrive(uint64_t* bar) "
                       "{ emu_mbar_arrive(bar); }",
    "consumer_sync": "inline void consumer_sync(int n) "
                     "{ emu_named_sync(n); }",
}


def func_span(s: str, name: str):
    """[start, end) of the definition of function ``name`` in ``s``."""
    i = s.index(name + "(")
    i = s.rindex("\n", 0, i) + 1
    depth = 0
    for k in range(s.index("{", i), len(s)):
        depth += s[k] == "{"
        depth -= s[k] == "}"
        if depth == 0:
            return i, k + 1
    raise ValueError(name)


def split_top(s: str) -> list:
    """``s`` split at its commas outside brackets."""
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "([<"
        depth -= ch in ")]>"
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def launch(m) -> str:
    kern, cfg, args = m.group(1), m.group(2), m.group(3)
    g, b = split_top(cfg)[:2]
    return (f"emu_launch(dim3({g.strip()}), dim3({b.strip()}), "
            f"[&] {{ {kern}({args}); }});")


def rewrite(s: str, name: str) -> str:
    for fn, body in EMU.items():
        if re.search(r"__device__ __forceinline__ \w+ " + fn + r"\(", s):
            i, j = func_span(s, fn)
            s = s[:i] + body + s[j:]
    s = re.sub(r'[ \t]*asm volatile\("(cp\.async\.wait_all|'
               r'fence\.mbarrier_init)[^\n]*\n', "", s)
    if "asm" in s:
        raise ValueError(f"{name}: inline PTX the emulation does not know")
    s = re.sub(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
               r"unsigned char* \1 = emu_dyn;", s)
    s = re.sub(r"extern __shared__ float (\w+)\[\];",
               r"float* \1 = reinterpret_cast<float*>(emu_dyn);", s)
    return re.sub(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);",
                  launch, s, flags=re.S)


def build(out: str) -> str:
    os.makedirs(out, exist_ok=True)
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            s = rewrite(f.read(), name)
        with open(os.path.join(out, name), "w") as f:
            f.write(s)
    so = os.path.join(out, "libemu.so")
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-pthread",
                    "-I", HERE, "-I", out, "-x", "c++",
                    *(os.path.join(out, n) for n in SOURCES), "-o", so],
                   check=True)
    return so


if __name__ == "__main__":
    print("built", build(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "filodb_tpu_torch", "_build", "emu")))
