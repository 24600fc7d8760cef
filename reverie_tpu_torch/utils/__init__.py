"""Host utilities of the port: `buildinfo` (the commit and dirty flag of
the checkout, for the CLI's version_info)."""
