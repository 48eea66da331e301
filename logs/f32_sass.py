"""Opcode histogram of each kernel in csrc/flash_attention_f32.cu (SASS of a
-cubin build): PYTHONPATH=. python3 logs/f32_sass.py"""
import collections
import os
import re
import subprocess
import tempfile

from gsoc_wav2vec2_tpu_torch.ops.kernels import _build

csrc = str(_build.CSRC_DIR)
with tempfile.TemporaryDirectory() as tmp:
    cubin = os.path.join(tmp, "fa32.cubin")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-cubin", "-o", cubin,
                    csrc + "/flash_attention_f32.cu"], check=True)
    out = subprocess.run(["cuobjdump", "-sass", cubin], capture_output=True, text=True, check=True).stdout
name, hist = None, {}
for line in out.splitlines():
    m = re.match(r"\s*Function : (\S+)", line)
    if m:
        name = re.sub(r".*?(flash_\w+?_kernel\w*?)E.*", r"\1", m.group(1))
        hist[name] = collections.Counter()
        continue
    m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
    if name and m:
        hist[name][m.group(1).split(".")[0]] += 1
for n, h in hist.items():
    print(n, sum(h.values()), dict(h.most_common(14)))
