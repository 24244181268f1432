"""The benchmark's plain float32 references: the two UNets, the diffusion
arithmetic (schedules, the ancestral step, the training loss, Adam and
the EMA) and the lower precisions of the controls. Plain ``torch`` and
``numpy``; nothing here imports the program under test."""
