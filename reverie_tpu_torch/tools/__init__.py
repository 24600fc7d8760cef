"""Measurement probes of the port on the card, each the counterpart of a
reverie_tpu tool with its CUDA kernel: `r2_measure` (AES keystream planes),
`r4_bwroof` (copy roof), `r5_u8emit` (u32 -> u8 byte emission) and
`r4_extract_probe` (pack-shift extraction).  Each has `run(device, ...)`,
which returns its results (device times only on a CUDA device), and `main`,
which runs it on the card:

    python -m reverie_tpu_torch.tools.r4_bwroof

`build_time` times the nvcc build of the kernels' library, parallel
against one nvcc over all sources; `wave_times` the wave kernels W1 and W2
and `tail_times` the BLAKE3 tail's hash legs (one tree against another's,
in one call); `tail_probe` where the tail kernel's time goes (its phases,
on builds cut by the macros csrc/blake3_tail.cu defines, and a
compression's latency and rate).

The CLI's helpers, reverie_tpu's tools of the same names:
`make_sha256_statement` writes a SHA-256 preimage statement's program and
witness files, `inspect_proof` prints a proof file's structure.
"""
