"""The benchmark of pcf_torch on one NVIDIA H100: `python3 perfbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>` (see run.py)."""
