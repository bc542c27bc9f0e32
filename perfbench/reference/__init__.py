"""The benchmark's plain reference: float64 PyTorch, written from the
models' equations. It imports nothing of the program and takes nothing the
program made; ``Precision("tf32")`` runs the same code one precision lower,
as the control that the comparison has to reject."""
