"""Command-line entry points (`cmd/`): `veneur`, the server."""
