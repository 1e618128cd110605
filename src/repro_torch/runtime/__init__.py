"""Runtime layer of the port: the typed event vocabulary, straggler
detection the serving scheduler reports through, and deterministic fault
injection (``chaos``)."""
