"""One module per kind of traffic, named by a mix's ``runner`` and found
by that name (``harness.cells.load_runner``). Each defines ``run(cell,
seed, seconds, traced, device, t_start) -> harness.outcome.Outcome``."""
