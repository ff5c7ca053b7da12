"""The benchmark of the PyTorch and CUDA port (``repro_torch``): federated
training of the paper's detector on the card, checked against a plain
reference.  Run ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""
