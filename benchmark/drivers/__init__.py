"""One module per kind of traffic; a mix's ``driver`` key names it. Each has
``setup(run)``, ``window(run, state)`` and ``check(run, state, window)``."""
