"""kkwbench: the benchmark of reverie_tpu_torch, the PyTorch and CUDA port.

One run of one cell (a configuration under a traffic mix, named in the
repository's BENCHMARK.json):

    python -m kkwbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See README.md.  Nothing under kkwbench imports jax, jaxlib or the JAX
package reverie_tpu; kkwbench.reference imports nothing of
reverie_tpu_torch either.
"""
