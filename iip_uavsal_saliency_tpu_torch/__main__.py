"""`python -m iip_uavsal_saliency_tpu_torch <command> ...`: the port's CLI
(`cli.py`), as `python -m iip_uavsal_saliency_tpu` runs the JAX package's."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
