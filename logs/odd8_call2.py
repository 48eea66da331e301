"""Phases 13g and 13h of chip_smoke.py alone, with stub records of the kernels their paths join."""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

t = time.perf_counter()
cs._build.library()
print(json.dumps({"build_s": time.perf_counter() - t}), flush=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
records = [{"name": n, "counter": n, "paths": ()} for n in
           ("groupnorm_stats", "fused_conv01", "pos_conv", "flash_attention_fwd", "flash_attention_bwd",
            "conv01_robust", "ctc_loss_fwd", "ctc_loss_bwd")]
walls = {}
t = time.perf_counter()
by_path = cs.pos_widths_phase(smi, records)
walls["pos_widths"] = time.perf_counter() - t
t = time.perf_counter()
by_path.update(cs.pos_widths_phase(smi, records, cs.POS_ODD8_WIDTHS, cs.POS_ODD8_MODELS, "pos_odd8"))
walls["pos_odd8"] = time.perf_counter() - t
for r in records:
    if "cg" in r["name"]:
        counter, paths = r["counter"], r["paths"]
        r["launches_by_path"] = {p: by_path[p][counter] for p in paths}
print(json.dumps({"walls": walls, "by_path": by_path}), flush=True)
print(json.dumps({"records": [r for r in records if "cg" in r["name"]]}, default=str), flush=True)
print(json.dumps({"kernels": [{k: r.get(k) for k in ("name", "ms", "plain_ms", "bound_ms", "library_ms",
                                                    "max_abs_err", "launches_by_path")}
                              for r in records if "cg" in r["name"]]}, default=str), flush=True)
