"""Runtime layer of the port: the typed event vocabulary and straggler
detection the serving scheduler reports through."""
