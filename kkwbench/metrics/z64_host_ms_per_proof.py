"""z64_host_ms_per_proof.prove / .verify: host milliseconds a proof of the
Z_2^64 openings' host work: in a prove the children "extract_z64" of
`challenge` (the Z_2^64 extraction's launches and uploads) and
"gather_z64" of `extract_pull` (its share of the pulled buffer split,
gathered and made bytes), in a verify "parse_z64" of `onl_inject` (the
Z_2^64 streams and keys of the online openings), over the window's calls.
A program without these spans reads nothing."""

CHILDREN = {"prove": ("extract_z64", "gather_z64"), "verify": ("parse_z64",)}


def read(window, part):
    if part != window.kind or not window.done:
        return None
    spans = [e - s for call in window.calls for row in call.timings.values()
             for child, s, e in row.get("spans", ()) if child in CHILDREN[part]]
    return sum(spans) / 1e6 / window.done if spans else None
