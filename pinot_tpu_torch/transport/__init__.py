"""The wire: REST front doors (``rest.py``), the remote state service
(``state_service.py``) and the gRPC query transport
(``grpc_transport.py``, the only module that imports ``grpc``)."""
