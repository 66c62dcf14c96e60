"""The benchmark of the PyTorch/CUDA port (``fluidframework_tpu_torch``):
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``run.py``."""
