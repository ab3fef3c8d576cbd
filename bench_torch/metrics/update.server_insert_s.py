"""Seconds of the server's insert (the port's ``server.insert`` span:
``add_points`` / ``replace_points`` and the host mirrors) per
``/updateIndex`` request (``server.update``) of the traced window."""

from harness import program


def read(run):
    return program.seconds_per(run, ("server.insert",), "server.update")
