"""The benchmark's plain reference. ``port/`` is a frozen copy of the port's
plain path (the task, the env framework, the plain physics step of
``ops/sim.py``, the networks and the PPO learner), taken when the benchmark
was defined and imported from here only: it imports nothing of the program.
Its physics is the plain PyTorch step, not the CUDA kernel the program
launches."""
