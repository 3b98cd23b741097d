"""Command-line tools of the port: ``launch`` (one process per rank) and
``dryrun`` (the multi-rank training legs)."""
