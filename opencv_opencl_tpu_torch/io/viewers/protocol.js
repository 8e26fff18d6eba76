/*
  Shared viewer-side signaling protocol handler: speaks BOTH reference
  dialects —

  - room dialect (webrtc/sender.cpp:269-339 / inn.html): join with a
    room; flat {type:'ice', room, candidate, sdpMLineIndex}; answers
    carry the room.
  - peer-id dialect (webrtc/vad.cpp:71-115 family): the server assigns
    an id via {type:'registered', id}; offers/answers carry from/to;
    ICE is {type:'ice-candidate', candidate:{candidate, sdpMLineIndex,
    sdpMid}, to}, with an EMPTY candidate string as the
    end-of-candidates signal (vad.cpp:100-104, ignored).

  The dialect is detected from the first offer: an offer carrying
  `from` switches replies to peer-id addressing (answer-carries-to,
  nested ICE), mirroring how the vad-family browsers answer.

  Pure logic (no DOM, no WebRTC): the pages inject `onOffer` (builds
  the RTCPeerConnection answer) and `onRemoteIce`; tests drive
  handleMessage/sendLocalIce directly.
*/
"use strict";

function createViewerProtocol(opts) {
  // opts: { room, send(obj), onOffer(sdp) -> Promise<answerSdp|null>,
  //         onRemoteIce({candidate, sdpMLineIndex}) }
  const state = { myId: null, peerId: null, dialect: "room" };

  async function handleMessage(msg) {
    if (!msg || typeof msg !== "object") return "bad-message";
    switch (msg.type) {
      case "registered":
        state.myId = msg.id || null;
        return "registered";
      case "offer": {
        if (msg.from) {
          state.peerId = msg.from;
          state.dialect = "peer";
        }
        const sdp = await opts.onOffer(msg.sdp);
        if (sdp == null) return "offer-ignored";
        const ans = { type: "answer", sdp: sdp };
        if (state.dialect === "peer") {
          ans.to = state.peerId;           // answer-carries-from protocol:
          if (state.myId) ans.from = state.myId;  // server stamps from too
        } else {
          ans.room = opts.room;
        }
        opts.send(ans);
        return "answered";
      }
      case "ice": {
        // flat room-dialect candidate
        if (!msg.candidate) return "end-of-candidates";
        opts.onRemoteIce({
          candidate: msg.candidate,
          sdpMLineIndex: msg.sdpMLineIndex | 0,
        });
        return "ice";
      }
      case "ice-candidate": {
        // nested peer-dialect candidate (vad.cpp:95-111)
        const c = msg.candidate || {};
        if (!c.candidate) return "end-of-candidates"; // vad.cpp:100-104
        if (msg.from) state.peerId = msg.from;
        opts.onRemoteIce({
          candidate: c.candidate,
          sdpMLineIndex: c.sdpMLineIndex | 0,
        });
        return "ice";
      }
    }
    return "unhandled";
  }

  function sendLocalIce(candidate, sdpMLineIndex) {
    if (state.dialect === "peer") {
      const msg = {
        type: "ice-candidate",
        candidate: {
          candidate: candidate,
          sdpMLineIndex: sdpMLineIndex,
          sdpMid: sdpMLineIndex === 1 ? "audio1" : "video0", // vad.cpp:119-127
        },
      };
      if (state.peerId) msg.to = state.peerId;
      opts.send(msg);
    } else {
      opts.send({
        type: "ice",
        room: opts.room,
        candidate: candidate,
        sdpMLineIndex: sdpMLineIndex,
      });
    }
  }

  function joinMessage() {
    return { type: "join", room: opts.room, clientType: "viewer" };
  }

  return {
    handleMessage: handleMessage,
    sendLocalIce: sendLocalIce,
    joinMessage: joinMessage,
    state: state,
  };
}

if (typeof module !== "undefined" && module.exports) {
  module.exports = { createViewerProtocol };
}
