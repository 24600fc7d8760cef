"""Per-layer metrics, one reader a file: `read(window, part)` -> the
metric's value, or None where the window holds nothing to read (the run
then leaves the metric out).  `part` is what follows the file's name in the
metric's name ("prove" or "verify"), or "" for a file of the whole name.
`window` is kkwbench.run.Window."""
