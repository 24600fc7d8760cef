"""Statement builders, one file each, found by the name a configuration's
file gives under "statement": `make(args, rng) -> program.Statement`."""
