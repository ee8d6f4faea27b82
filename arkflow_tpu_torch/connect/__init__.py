"""Broker protocol clients on asyncio, with no client library.

Counterpart of ``arkflow_tpu/connect/``: Kafka (``kafka_client``), MQTT
3.1.1 (``mqtt_client``), Redis RESP2 with cluster routing
(``redis_client``) and NATS core (``nats_client``), each speaking its wire
protocol over ``asyncio`` streams.
"""


def make_ssl_context(tls: dict):
    """Build an ssl.SSLContext from connector config:
    ``{ca_file: ..., cert_file: ..., key_file: ..., insecure_skip_verify: false}``."""
    import ssl

    ctx = ssl.create_default_context(cafile=tls.get("ca_file"))
    if tls.get("cert_file"):
        ctx.load_cert_chain(tls["cert_file"], tls.get("key_file"))
    if tls.get("insecure_skip_verify"):
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx
