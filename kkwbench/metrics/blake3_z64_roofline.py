"""blake3_z64_roofline.prove / .verify: the transcript hash, K3 and the tail,
against their bounds (blake3_roofline.leg_work), in a circuit on W2, whose
Z_2^64 streams the program's shape does not count: each leg's stream
lengths a rep are the executor rows' counter w2_work (onl2, pre2, onlz,
prez; scan_z64_roofline).  A prove and an online verify hash the four
streams, a preprocessing verify the two preprocessing ones.  A program
without the counter reads nothing."""

from kkwbench.driver import VERIFY_PRE
from kkwbench.metrics._roofline import legs, share
from kkwbench.metrics.blake3_roofline import leg_work
from kkwbench.metrics.scan_z64_roofline import _by_role


def lengths(sizes: dict, role: int):
    """The byte lengths a rep of the streams a leg of `role` hashes."""
    if role == VERIFY_PRE:
        return sizes["pre2"], sizes["prez"]
    return sizes["pre2"], sizes["onl2"], sizes["prez"], sizes["onlz"]


def read(window, part):
    by_role = _by_role(window, part)
    if not by_role:
        return None
    bounds = []
    for role, R in legs(window, part):
        if role not in by_role:
            return None
        bounds += leg_work(lengths(by_role[role], role), R)
    return share(window, "blake3_", bounds)
