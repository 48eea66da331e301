"""Compare the SASS of every function two cubins share: python3 sass_compare.py OLD NEW."""
import re
import subprocess
import sys


def functions(cubin):
    out = subprocess.run(["cuobjdump", "-sass", cubin], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # the anonymous namespace's hash depends on the source's path
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+", r"\1", m.group(1))
            funcs[name] = []
            continue
        if name:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line.split(";")[0]).strip()
            if ins and not ins.startswith("/*") and "." != ins:
                funcs[name].append(ins)
    return funcs


old, new = functions(sys.argv[1]), functions(sys.argv[2])
same = [n for n in old if n in new and old[n] == new[n]]
diff = [n for n in old if n in new and old[n] != new[n]]
print(f"functions: old {len(old)} new {len(new)} shared {len(same) + len(diff)} identical {len(same)}")
for n in diff:
    print("DIFFERS", n, len(old[n]), len(new[n]))
for n in old:
    if n not in new:
        print("ONLY OLD", n)
