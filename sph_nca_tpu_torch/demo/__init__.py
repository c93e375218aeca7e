"""The interactive demo: ``server`` steps the band engine on the card and
streams RGBA frames to ``static/index.html``; ``engine`` is the independent
numpy forward path it is checked against."""
