"""python -m gromacs_fep_gpu_tpu_torch <command> ...: the CLI on the GPU."""
from .cli import main

main()
