"""Phase 13i of chip_smoke.py alone (after the build), its records and walls;
with `wide`, phase 13j (head dims 128, 192 and 256) instead:
PYTHONPATH=. python3 logs/phase13i.py [wide]"""
import json
import subprocess
import sys
import time

import torch

import chip_smoke as cs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(smi, flush=True)
t = time.time()
cs._build.library()
print("build s", time.time() - t, flush=True)
records = []
t = time.time()
if sys.argv[1:] == ["wide"]:
    by_path = cs.f32_phase(smi, records, cs.F32_WIDE_KERNELS, cs.F32_WIDE_MODELS, "f32_wide_kernels")
else:
    by_path = cs.f32_phase(smi, records)
print("phase s", time.time() - t, flush=True)
for r in records:
    counter, paths = r.pop("counter"), r.pop("paths")
    r["launches_by_path"] = {p: by_path[p][counter] for p in paths}
print(json.dumps({"kernels": records}), flush=True)
