"""HTTP serving: ``server.SlimServer``, ``client.SlimClient`` and the wire
codec of ``serve/query.proto`` (``wire``), with no protobuf package."""
