"""The port's benchmark: data-parallel DGS training through the PyTorch
port's train step on one H100.  ``python3 portbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` runs one cell once."""
