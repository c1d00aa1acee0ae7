"""The OpenAI-compatible server of the port (`openai_server`), its request
schemas (`openai_protocol`) and the tool-call and reasoning parsers."""
